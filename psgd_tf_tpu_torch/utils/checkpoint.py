"""Checkpoint and resume for PSGD training.

Counterpart of `psgd_tf_tpu/utils/checkpoint.py`, over `torch.save` and
`torch.load(weights_only=True)` instead of orbax. A training state is one
tree (`utils._tree`): for example `{"params": [...], "opt": PSGDState,
"gen": torch.Generator}`. Saving it keeps the parameters, every field of
`PSGDState` with its `Hyper`, the preconditioner (each family's state, the
Kronecker factors, `KronPrecond`'s stacked `BatchedDDState` buckets) and
the state of every `torch.Generator` in the tree (the CPU coin and branch
generators of `PSGDState`, a data or probe generator on the card), so a
restored run continues the same trajectory.

On disk, `directory/<step>/state.pt` holds only tensors, dicts, lists,
numbers and strings: `{"format": FORMAT, "tree": ...}`, where a tuple, a
dict, a dataclass or NamedTuple and a generator are dicts tagged with
`"__type__"` (the dataclass's qualified type name beside its fields, a
generator's device beside its `get_state()`), so a checkpoint can be read
without this package.

`restore(..., like=fresh)` rebuilds the tree of `fresh` (for example a
freshly `init`-ed state): its dataclasses, each tensor on `fresh`'s device
and dtype, each generator a new one on `fresh`'s device with the saved
state. A checkpoint whose structure, shapes or format differ from `like`'s
is refused with a ValueError naming the first field that differs: a silent
layout change must not restore. Numbers are restored from the file, except
inside tuples (layout, such as a bucket's layer indices), where they must
equal `like`'s, as strings, None and bools must.

On a mesh (`parallel`), save `policies.gather_state(mesh, local, n)` on
rank 0, and after `restore` on every rank, `policies.shard_state(mesh,
state)`: the port's counterpart of orbax's per-process shards.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
from typing import Any

import torch

from psgd_tf_tpu_torch.utils import _tree

Step = int
FORMAT = 1
_FILE = "state.pt"
_TYPE = "__type__"


def save(directory: str, step: Step, train_state: Any, *, force: bool = False) -> None:
    """Write `train_state` under `directory/<step>/`. Raises
    FileExistsError when that step exists, unless `force`."""
    directory = os.path.abspath(directory)
    path = os.path.join(directory, str(step))
    if os.path.exists(path) and not force:
        raise FileExistsError(f"checkpoint {path} exists; pass force=True to replace it")
    payload = {"format": FORMAT, "tree": _encode(train_state, "")}
    os.makedirs(directory, exist_ok=True)
    # written under a private name and renamed: a reader never sees half a step
    tmp = tempfile.mkdtemp(dir=directory, prefix=f".{step}.")
    try:
        torch.save(payload, os.path.join(tmp, _FILE))
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def restore(directory: str, step: Step | None = None, like: Any = None) -> Any:
    """Load a checkpoint; `step=None` loads the latest (FileNotFoundError
    when there is none). Without `like` the tree comes back as stored:
    CPU tensors, dicts, lists and tuples, and tagged dicts for dataclasses
    and generators. With `like`, as the module docstring says."""
    directory = os.path.abspath(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    payload = torch.load(os.path.join(directory, str(step), _FILE), map_location="cpu",
                         weights_only=True)
    if not isinstance(payload, dict) or payload.get("format") != FORMAT:
        found = payload.get("format") if isinstance(payload, dict) else type(payload).__name__
        raise ValueError(f"checkpoint format {found!r}; this reader reads format {FORMAT}")
    if like is None:
        return _decode(payload["tree"])
    return _restore_like(payload["tree"], like, "", in_tuple=False)


def latest_step(directory: str) -> Step | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d) for d in os.listdir(directory) if d.isdigit()]
    return max(steps) if steps else None


def _type_name(x: Any) -> str:
    cls = type(x)
    return f"{cls.__module__}.{cls.__qualname__}"


def _encode(x: Any, path: str) -> Any:
    if isinstance(x, torch.Tensor):
        # a compact CPU copy: a view would otherwise save its whole storage
        return x.detach().to("cpu").clone(memory_format=torch.contiguous_format)
    if isinstance(x, torch.Generator):
        return {_TYPE: "torch.Generator", "device": str(x.device), "state": x.get_state()}
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, dict):
        bad = [k for k in x if not isinstance(k, str)]
        if bad:
            raise TypeError(f"checkpoint: dict keys must be strings, {path or 'the root'} "
                            f"has {bad[0]!r}")
        return {_TYPE: "dict", "items": {k: _encode(v, f"{path}[{k!r}]") for k, v in x.items()}}
    if (dataclasses.is_dataclass(x) and not isinstance(x, type)) or _tree.is_namedtuple(x):
        return {_TYPE: _type_name(x),
                "fields": {s[1:]: _encode(v, path + s) for s, v in _tree.children(x)}}
    if isinstance(x, list):
        return [_encode(v, f"{path}[{i}]") for i, v in enumerate(x)]
    if isinstance(x, tuple):
        return {_TYPE: "tuple", "items": [_encode(v, f"{path}[{i}]") for i, v in enumerate(x)]}
    raise TypeError(f"checkpoint: cannot save {type(x).__name__} at {path or 'the root'}")


def _decode(x: Any) -> Any:
    if isinstance(x, list):
        return [_decode(v) for v in x]
    if not isinstance(x, dict):
        return x
    kind = x[_TYPE]
    if kind == "dict":
        return {k: _decode(v) for k, v in x["items"].items()}
    if kind == "tuple":
        return tuple(_decode(v) for v in x["items"])
    if "fields" in x:
        return {_TYPE: kind, "fields": {k: _decode(v) for k, v in x["fields"].items()}}
    return x  # a generator


def _mismatch(path: str, what: str) -> ValueError:
    return ValueError(f"checkpoint does not match `like` at {path or 'the root'}: {what}")


def _kind(enc: Any) -> str:
    if isinstance(enc, dict):
        return str(enc.get(_TYPE))
    return "tensor" if isinstance(enc, torch.Tensor) else type(enc).__name__


def _restore_like(enc: Any, like: Any, path: str, in_tuple: bool) -> Any:
    """`enc` rebuilt as `like`'s tree; raises at the first difference."""
    if isinstance(like, torch.Tensor):
        if not isinstance(enc, torch.Tensor):
            raise _mismatch(path, f"a tensor in `like`, {_kind(enc)} in the checkpoint")
        if tuple(enc.shape) != tuple(like.shape):
            raise _mismatch(path, f"shape {tuple(enc.shape)} in the checkpoint, "
                                  f"{tuple(like.shape)} in `like`")
        out = enc.to(device=like.device, dtype=like.dtype)
        return out.requires_grad_() if like.requires_grad else out
    if isinstance(like, torch.Generator):
        if _kind(enc) != "torch.Generator":
            raise _mismatch(path, f"a generator in `like`, {_kind(enc)} in the checkpoint")
        gen = torch.Generator(device=like.device)
        gen.set_state(enc["state"])
        return gen
    if like is None or isinstance(like, (bool, str)) or (
            in_tuple and isinstance(like, (int, float))):
        if type(enc) is not type(like) or enc != like:
            raise _mismatch(path, f"{enc!r} in the checkpoint, {like!r} in `like`")
        return enc
    if isinstance(like, (int, float)):
        if type(enc) is not type(like):
            raise _mismatch(path, f"{_kind(enc)} in the checkpoint, {type(like).__name__} "
                                  "in `like`")
        return enc
    if isinstance(like, list):
        if not isinstance(enc, list) or len(enc) != len(like):
            raise _mismatch(path, f"{_size(enc)} in the checkpoint, a list of {len(like)} "
                                  "in `like`")
        return [_restore_like(e, l, f"{path}[{i}]", in_tuple)
                for i, (e, l) in enumerate(zip(enc, like))]
    if isinstance(like, dict):
        if _kind(enc) != "dict":
            raise _mismatch(path, f"a dict in `like`, {_kind(enc)} in the checkpoint")
        items = enc["items"]
        _same_keys(path, list(items), list(like), lambda k: f"[{k!r}]")
        return {k: _restore_like(items[k], v, f"{path}[{k!r}]", in_tuple)
                for k, v in like.items()}
    if (dataclasses.is_dataclass(like) and not isinstance(like, type)) or _tree.is_namedtuple(like):
        if _kind(enc) != _type_name(like):
            raise _mismatch(path, f"{_kind(enc)} in the checkpoint, {_type_name(like)} in "
                                  "`like`")
        fields = enc["fields"]
        kids = _tree.children(like)
        _same_keys(path, list(fields), [s[1:] for s, _ in kids], lambda k: f".{k}")
        values = {s[1:]: _restore_like(fields[s[1:]], v, path + s, in_tuple) for s, v in kids}
        if _tree.is_namedtuple(like):
            return type(like)(**values)
        return dataclasses.replace(like, **values)
    if isinstance(like, tuple):
        if _kind(enc) != "tuple" or len(enc["items"]) != len(like):
            raise _mismatch(path, f"{_size(enc)} in the checkpoint, a tuple of {len(like)} "
                                  "in `like`")
        return tuple(_restore_like(e, l, f"{path}[{i}]", True)
                     for i, (e, l) in enumerate(zip(enc["items"], like)))
    raise TypeError(f"checkpoint: cannot restore into {type(like).__name__} at "
                    f"{path or 'the root'}")


def _same_keys(path: str, saved: list, wanted: list, step) -> None:
    """Raise naming the first key that only one side has."""
    odd = [k for k in wanted if k not in saved] + [k for k in saved if k not in wanted]
    if odd:
        where = "`like`" if odd[0] in wanted else "the checkpoint"
        raise _mismatch(path + step(odd[0]), f"only in {where}")


def _size(enc: Any) -> str:
    if isinstance(enc, list):
        return f"a list of {len(enc)}"
    if _kind(enc) == "tuple":
        return f"a tuple of {len(enc['items'])}"
    return _kind(enc)
