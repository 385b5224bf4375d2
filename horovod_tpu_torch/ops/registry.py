"""The ported kernel families and their launch counters.

Counterpart of ``horovod_tpu/ops/pallas.py::KERNEL_CONTRACTS``.  Each
family names the CUDA source that implements it and the TPU kernel it
replaces, and carries a plain-int launch counter: the wrapper adds one
where it launches the kernel and nowhere else, so a run can show that
its main path really went through the kernel.

There is no switch between kernel and plain version here: a CUDA tensor
goes through the kernel (or the wrapper raises), a CPU tensor through
the plain PyTorch version, and ``force_reference=True`` is the one
explicit way to call the plain version on the GPU.
"""

from __future__ import annotations

from typing import Dict

KERNEL_CONTRACTS = {
    "flash": {
        "source": "horovod_tpu_torch/ops/csrc/flash_fwd.cu",
        "site": "ops.attention.flash_attention",
        "replaces": "horovod_tpu/ops/attention.py::_flash_fwd",
        "note": "FlashAttention-2 forward (O and logsumexp)",
    },
    "flash_bwd_dq": {
        "source": "horovod_tpu_torch/ops/csrc/flash_bwd.cu",
        "site": "ops.attention.flash_backward_dq (flash_attention's "
                "backward)",
        "replaces": "horovod_tpu/ops/attention.py::_flash_bwd (_dq_kernel)",
        "note": "dq = sum over keys of ds K, ds = p (dp - delta) scale",
    },
    "flash_bwd_dkv": {
        "source": "horovod_tpu_torch/ops/csrc/flash_bwd.cu",
        "site": "ops.attention.flash_backward_dkv (flash_attention's "
                "backward)",
        "replaces": "horovod_tpu/ops/attention.py::_flash_bwd "
                    "(_dkv_kernel)",
        "note": "dv = p^T dO, dk = ds^T Q, summed over each GQA group "
                "inside the kernel",
    },
    "flash_decode": {
        "source": "horovod_tpu_torch/ops/csrc/flash_decode.cu",
        "site": "ops.attention.paged_decode_attention / decode_attention",
        "replaces": "horovod_tpu/ops/attention.py::_flash_decode",
        "note": "split-KV single-token attention read through the page "
                "table, plus a log-sum-exp merge pass",
    },
    "bn_bwd_reduce": {
        "source": "horovod_tpu_torch/ops/csrc/bn_bwd.cu",
        "site": "ops.bn.bn_backward_reduce (bn_train's backward, every "
                "BatchNorm site in train mode)",
        "replaces": "horovod_tpu/ops/bn.py::_bn_bwd_kernels "
                    "(_reduce_kernel)",
        "note": "per channel dbeta = sum(dy), dgamma = sum(dy * xhat): "
                "per-chunk partials, then a fixed-order finishing launch "
                "(counted with it, once per call)",
    },
    "bn_bwd_dx": {
        "source": "horovod_tpu_torch/ops/csrc/bn_bwd.cu",
        "site": "ops.bn.bn_backward_dx (bn_train's backward)",
        "replaces": "horovod_tpu/ops/bn.py::_bn_bwd_kernels (_dx_kernel)",
        "note": "dx = scale * inv * (dy - dbeta / n - xhat * dgamma / n)",
    },
    "fused_update_matricize_p": {
        "source": "horovod_tpu_torch/ops/csrc/fused_update.cu",
        "site": "ops.fused_update.matricize_p (powersgd_allreduce stage 1)",
        "replaces": "horovod_tpu/ops/fused_update.py::matricize_p",
        "note": "acc = x * prescale (+ residual) over the [m, c] view of "
                "the flat bucket (zero past its end), P = acc @ Q0",
    },
    "fused_update_orthonormalize_q": {
        "source": "horovod_tpu_torch/ops/csrc/fused_update.cu",
        "site": "ops.fused_update.orthonormalize_q (stage 2, after the P "
                "allreduce)",
        "replaces": "horovod_tpu/ops/fused_update.py::orthonormalize_q",
        "note": "modified Gram-Schmidt of the mean P (one CTA), then "
                "Q_local = acc^T @ P_orth as per-chunk partials and a "
                "fixed-order finishing launch (counted once per call)",
    },
    "fused_update_reconstruct": {
        "source": "horovod_tpu_torch/ops/csrc/fused_update.cu",
        "site": "ops.fused_update.reconstruct_residual (stage 3, after "
                "the Q allreduce)",
        "replaces": "horovod_tpu/ops/fused_update.py::reconstruct_residual",
        "note": "out = (P_orth Q^T) * n_scale * postscale, residual = acc "
                "- P_orth Q_local^T, at the bucket's flat length",
    },
}

_launches: Dict[str, int] = {name: 0 for name in KERNEL_CONTRACTS}


def note_launch(family: str) -> None:
    """Count one kernel launch of ``family`` (called by its wrapper)."""
    _launches[family] += 1


def launches(family: str) -> int:
    return _launches[family]


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0

