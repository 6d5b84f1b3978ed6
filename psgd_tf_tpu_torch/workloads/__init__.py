"""The reference demo suite as runnable workloads. Counterpart of
`psgd_tf_tpu/workloads/`.

Each module exposes `run(**overrides) -> dict` returning at least
`{"loss": float, "success": bool, "steps": int}` with the reference's own
success criterion, and runs on the card unless `device` says otherwise:

    python -m psgd_tf_tpu_torch run hello_psgd
    python -m psgd_tf_tpu_torch.workloads.hello_psgd
"""
from psgd_tf_tpu_torch.workloads import (
    all_preconditioners,
    hello_psgd,
    lstm_xor,
    mnist_lenet5,
    nmt_attention,
    rnn_xor_lra,
)

__all__ = [
    "all_preconditioners",
    "hello_psgd",
    "lstm_xor",
    "mnist_lenet5",
    "nmt_attention",
    "rnn_xor_lra",
]
