"""The lra update on a state or probe holding one NaN or inf (the case that
faulted K13's corner kernel on the card), on the CPU: the port's plain K13
chain (`lra_upd.fused_update(_apply)`) and K14's chain on a one-rank mesh
(`fused_update(_apply)_sharded`, pipelined off and on) against the JAX
package's `_update_impl` (`fused_update(_apply)`) and
`fused_update(_apply)_sharded` on a one-device mesh, both in interpret mode.
Inputs come from numpy and the coins are injected, as in
`tests/test_torch_parallel.py`. Every output must be non-finite exactly
where JAX's is, and agree with it elsewhere within 5e-4 of its largest
finite entry. The kernels are held to the same plain chain on the card
(`tests/test_torch_hopper.py`, `chip_smoke.py`)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psgd_tf_tpu.groups import lra as jlra
from psgd_tf_tpu.ops import linalg as jlinalg
from psgd_tf_tpu.ops.pallas import lra_upd as jlra_upd
from psgd_tf_tpu.parallel import make_mesh as jmake_mesh
from psgd_tf_tpu_torch.ops.hopper import lra_upd
from psgd_tf_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)
TINY = jlinalg.tiny(jnp.float32)
COINS = [(False, False), (False, True), (True, False), (True, True)]
N = 300
CASES = [(r, where, value) for r in (4, 40) for where in ("UV", "d", "v")
         for value in (np.nan, np.inf)]


@pytest.fixture(scope="module")
def coin_keys():
    """One JAX key per coin pair (balance, update_u), as `_update_impl`
    splits it."""
    keys, i = {}, 0
    while len(keys) < 4:
        k = jax.random.PRNGKey(300000 + i)
        i += 1
        k_bal, k_uv = jax.random.split(k)
        coins = (bool(jax.random.uniform(k_bal, dtype=jnp.float32) < 0.01),
                 bool(jax.random.uniform(k_uv, dtype=jnp.float32) < 0.5))
        keys.setdefault(coins, k)
    return keys


@pytest.fixture(scope="module")
def meshes():
    """JAX's sharded entries on a one-device mesh, jitted (traced once a
    rank), and the port's one-rank mesh (a shard axis of one: its
    reductions are the identity, as on one NCCL rank)."""
    jm = jmake_mesh(data=1, shard=1, devices=jax.devices()[:1])
    jit = lambda fn: jax.jit(functools.partial(fn, tiny=TINY, mesh=jm, interpret=True))
    tm = Mesh(data=1, shard=1, data_rank=0, shard_rank=0, data_group=None, shard_group=None,
              backend="gloo", device=torch.device("cpu"))
    return jit(jlra_upd.fused_update_apply_sharded), jit(jlra_upd.fused_update_sharded), tm


def _inputs(r, where, value):
    st = jlra.init(jax.random.PRNGKey(r), N, rank=r, init_scale=0.8)
    UV, d = np.array(st.UV, dtype=np.float32), np.array(st.d, dtype=np.float32)
    UV[:r] *= 3.0  # imbalanced: a rebalance moves it
    rng = np.random.default_rng(r)
    v, h, g = (rng.standard_normal(N).astype(np.float32) for _ in range(3))
    target = {"UV": UV.reshape(-1), "d": d, "v": v}[where]
    target[int(rng.integers(target.size))] = value
    return UV, d, v, h, g


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _same(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    bad = ~np.isfinite(want)
    assert np.array_equal(~np.isfinite(got), bad), f"{what}: non-finite entries differ"
    if not bad.all():
        scale = max(1.0, float(np.abs(want[~bad]).max()))
        np.testing.assert_allclose(got[~bad], want[~bad], rtol=0, atol=5e-4 * scale,
                                   err_msg=what)


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"r{r}-{w}-{v}" for r, w, v in CASES])
def test_nonfinite_lra_matches_jax(coin_keys, meshes, case):
    r, where, value = CASES[case]
    coins = COINS[case % 4]
    key = coin_keys[coins]
    j_apply_sharded, j_update_sharded, tm = meshes
    UV, d, v, h, g = _inputs(r, where, value)
    want_apply = jlra_upd.fused_update_apply(UV, d, v, h, g, 0.05, key, TINY, interpret=True)
    want = jlra_upd.fused_update(UV, d, v, h, 0.05, key, TINY, interpret=True)
    for name, got in [
        ("jax sharded", j_apply_sharded(UV, d, v, h, g, 0.05, key)),
        ("k13 plain", lra_upd.fused_update_apply(_t(UV), _t(d), _t(v), _t(h), _t(g), 0.05,
                                                 coins)),
        *[(f"k14 pipelined={p}", lra_upd.fused_update_apply_sharded(
            _t(UV), _t(d), _t(v), _t(h), _t(g), 0.05, coins, tm, pipelined=p))
          for p in (False, True)]]:
        for a, b, part in zip(got, want_apply, ("UV'", "d'", "P'g"), strict=True):
            _same(a, b, f"{name} apply {part}")
    for name, got in [
        ("jax sharded", j_update_sharded(UV, d, v, h, 0.05, key)),
        ("k13 plain", lra_upd.fused_update(_t(UV), _t(d), _t(v), _t(h), 0.05, coins)),
        ("k14", lra_upd.fused_update_sharded(_t(UV), _t(d), _t(v), _t(h), 0.05, coins, tm))]:
        for a, b, part in zip(got, want, ("UV'", "d'"), strict=True):
            _same(a, b, f"{name} update {part}")


def test_plain_reductions_keep_nan():
    """The plain chain's maxima and step scales, which the kernels now
    follow: a NaN max|nablaD| gives a NaN step scale (where fminf gave the
    fp32 max), an inf one a zero scale, a NaN entry a NaN stage-1 maximum."""
    mu, _ = lra_upd.corner_b_plain(torch.tensor(float("nan")), 0.05)
    assert torch.isnan(mu)
    mu, _ = lra_upd.corner_b_plain(torch.tensor(float("inf")), 0.05)
    assert mu.item() == 0.0
    UV = torch.ones(4, 8)
    UV[1, 3] = float("nan")
    _, maxs = lra_upd.stage1_plain(UV, torch.ones(8), torch.ones(8), torch.ones(8))
    assert torch.isnan(maxs[0]) and maxs[1].item() == 1.0
