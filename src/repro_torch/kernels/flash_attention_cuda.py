"""Flash attention on Hopper — the counterpart of ``repro.kernels.flash_attention``.

``flash_attention(q, k, v)`` computes multi-head attention with an online
softmax for q ``[B, Sq, H, D]`` and k, v ``[B, Sk, Hkv, D]`` (GQA when
Hkv < H), optionally causal and/or windowed, with queries aligned at
``Sk - Sq``, through a hand-written CUDA kernel: bf16 at head width 256 in
``csrc/flash_attention_wgmma.cu`` (``wgmma`` and TMA), every other head
width and dtype in ``csrc/flash_attention.cu`` (``mma.sync``); each
source's header note gives its design and bound, and ``kernel_library``
picks between them. The statistics are f32 and the output takes q's
dtype.

The wrapper takes the kernel's plain PyTorch version
(``flash_attention_plain``) only for tensors on the CPU. CUDA tensors launch
the kernel or raise, through the operator ``flash_attention_op``
(``repro_torch::flash_attention``), whose meta version lets a program on
the meta device count the kernel's work (``launch.dryrun``). ``LAUNCHES``
counts each kernel's launches (``flash_attention``: the mma.sync kernel;
``flash_attention_wgmma``: bf16 at D 256), so a run can show that its path
went through them.

Gradients: when grad is enabled and an input requires it, the call goes
through ``_FlashAttention``, a ``torch.autograd.Function`` whose forward is
the same launch (the plain version on the CPU) and whose backward is the
attention's VJP in torch ops (``attention_vjp``): what ``jax.grad`` of the
JAX package's ``attention_ref`` computes. The JAX package defines no
backward for its flash kernel, so the port writes no backward kernel.
Without grad the wrapper launches the kernel directly, as serving does.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch import tracing
from repro_torch.kernels import _build

#: the CUDA sources of the kernel, relative to the repository root: the
#: ``mma.sync`` kernel, and the ``wgmma`` kernel of bf16 at head width 256
SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
WGMMA_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu"

#: the TPU kernel it replaces
REPLACES = "src/repro/kernels/flash_attention.py:28"

#: each kernel's launches since the last ``reset_launches()``, by library
LAUNCHES = {"flash_attention": 0, "flash_attention_wgmma": 0}

#: head widths the kernel is compiled for
HEAD_DIMS = (16, 32, 64, 128, 256)

#: the Pallas kernel's mask value and the floor of the softmax denominator
NEG_INF = -1e30
L_FLOOR = 1e-30

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_Y = 65535


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def kernel_library(d: int, dtype: torch.dtype) -> str:
    """The library (``csrc/<name>.cu``) whose kernel runs head width ``d`` in
    ``dtype``: bf16 at D 256 runs the ``wgmma`` kernel, everything else the
    ``mma.sync`` one."""
    if d == 256 and dtype == torch.bfloat16:
        return "flash_attention_wgmma"
    return "flash_attention"


@functools.cache
def _lib(name: str = "flash_attention") -> ctypes.CDLL:
    lib = _build.load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "flash_attention_wgmma":
        lib.awb_flash_attention_wgmma.argtypes = [p] * 4 + [i] * 8 + [ctypes.c_float, p]
        lib.awb_flash_attention_wgmma.restype = i
        lib.awb_flash_attention_wgmma_smem.argtypes = []
        lib.awb_flash_attention_wgmma_smem.restype = i
        return lib
    lib.awb_flash_attention.argtypes = [p] * 4 + [i] * 8 + [ctypes.c_float, i, p]
    lib.awb_flash_attention.restype = i
    lib.awb_flash_attention_smem.argtypes = [i, i]
    lib.awb_flash_attention_smem.restype = i
    return lib


def shared_bytes(d: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block of the kernel at head width ``d``
    in ``dtype`` (builds the kernel on first use)."""
    if kernel_library(d, dtype) == "flash_attention_wgmma":
        return _lib("flash_attention_wgmma").awb_flash_attention_wgmma_smem()
    return _lib().awb_flash_attention_smem(d, int(dtype == torch.bfloat16))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be [B, S, H, D]")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(
            f"k {tuple(k.shape)} and v {tuple(v.shape)} do not match q "
            f"{tuple(q.shape)}: they must be [B, Sk, Hkv, D] with q's B and D")
    if h % k.shape[2] != 0:
        raise ValueError(f"{h} query heads do not divide into {k.shape[2]} kv heads")
    if window is not None and window < 1:
        raise ValueError(f"window must be a positive number of keys, not {window}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Attention ``[B, Sq, H, D]`` in q's dtype. Tensors on the CPU run the
    plain version; CUDA tensors (contiguous, 16-byte aligned) run the
    kernel. Differentiable: with grad enabled and an input that requires
    it, through ``_FlashAttention``.

    A NaN in q or k gives NaN in every output row that sees it, as the plain
    version does. A NaN in v reaches the rows of each tile of keys that the
    kernel visits; the plain version, which also multiplies the masked
    keys' zero weights, spreads it to every row of the head."""
    _check(q, k, v, window)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window, scale)
    return _forward(q, k, v, causal, window, scale)


def _forward(q, k, v, causal, window, scale) -> torch.Tensor:
    """The kernel's launch (``flash_attention_op``), or the plain version
    for tensors on the CPU. Meta tensors take the operator's meta version,
    which the dry-run counts (``launch.dryrun``)."""
    devices = {t.device for t in (q, k, v)}
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    if len(devices) != 1 or not (q.is_cuda or q.is_meta):
        raise ValueError(f"q, k and v lie on {sorted(map(str, devices))}; "
                         "the kernel needs them all on one CUDA device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"q, k, v are {q.dtype}, {k.dtype}, {v.dtype}; the "
                         "kernel takes all float32 or all bfloat16")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous [B, S, H, D]")
    if q.is_cuda and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start on a 16-byte boundary: the kernels "
                         "copy them with 16-byte cp.async or TMA")
    b, _, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head width {d}; the kernel is built for {HEAD_DIMS}")
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"B·H = {b * h} exceeds the grid's {_MAX_GRID_Y}")
    return flash_attention_op(q, k, v, bool(causal), int(window or 0),
                              float(d ** -0.5 if scale is None else scale))


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                       window: int, scale: float) -> torch.Tensor:
    """The kernel's launch as an operator (``window`` 0: none) on tensors
    ``_forward`` has checked. Its meta version allocates the output and
    nothing else, and ``FlopCounterMode`` counts it by ``_flops``: a program
    on the meta device counts the attention the card runs, with no S × S
    tensor."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    name = kernel_library(d, q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        LAUNCHES[name] += 1
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, sk,
                h, hkv, d, int(causal), window, scale)
        if name == "flash_attention_wgmma":
            err = _lib(name).awb_flash_attention_wgmma(*args, stream)
        else:
            err = _lib(name).awb_flash_attention(*args, int(q.dtype == torch.bfloat16),
                                                 stream)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return out


@flash_attention_op.register_fake
def _(q, k, v, causal, window, scale):
    return torch.empty_like(q)


def visible_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """The (query, key) pairs the masks leave visible, queries aligned at
    Sk − Sq: what the kernel must compute."""
    qpos = np.arange(sq) + (sk - sq)
    hi = np.minimum(qpos + 1, sk) if causal else np.full(sq, sk)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.clip(hi - lo, 0, None).sum())


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flops(q_shape, k_shape, v_shape, causal, window, scale, *args, **kwargs) -> int:
    """Q·Kᵀ and P·V over the visible pairs: 4·B·H·D a pair."""
    b, sq, h, d = q_shape
    return 4 * b * h * d * visible_pairs(sq, k_shape[1], causal, window)


class _FlashAttention(torch.autograd.Function):
    """The flash kernel's forward (``_forward``) with the attention's VJP in
    torch ops as its backward, under the profiler range ``attention.vjp``
    while a profiler records."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        out = _forward(q, k, v, causal, window, scale)
        ctx.save_for_backward(q, k, v, out)
        ctx.mask = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        with tracing.span("attention.vjp"):
            grads = attention_vjp(q, k, v, out, dout, *ctx.mask)
        return (*grads, None, None, None)


def _mask(sq: int, sk: int, causal: bool, window, device) -> torch.Tensor:
    """``[Sq, Sk]``: the keys each query sees, queries aligned at Sk − Sq."""
    qpos = torch.arange(sq, device=device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def attention_vjp(q, k, v, out, dout, causal=True, window=None, scale=None) -> tuple:
    """(dq, dk, dv) of the attention ``out`` = softmax(scale·QKᵀ, masked)·V
    for the output gradient ``dout``, in f32, cast to the inputs' dtypes:
    S recomputed with the kernel's mask (``NEG_INF``), P = softmax(S),
    dV = PᵀdO, dS = P∘(dO·Vᵀ − rowsum(dO∘O)), dQ = dS·K·scale,
    dK = dSᵀ·Q·scale, dK and dV summed over each GQA group. A row that sees
    no key (causal, Sq > Sk) has the uniform P of the forward's mean(V)."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    groups = h // hkv
    if scale is None:
        scale = d ** -0.5
    qf, do = q.float(), dout.float()
    kf = k.float().repeat_interleave(groups, dim=2)
    vf = v.float().repeat_interleave(groups, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    s = torch.where(_mask(sq, sk, causal, window, q.device), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    del s
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    ds = torch.einsum("bqhd,bkhd->bhqk", do, vf)
    rowsum = (do * out.float()).sum(-1).transpose(1, 2)[..., None]  # [B, H, Sq, 1]
    ds.sub_(rowsum).mul_(p)
    del p
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dk = dk.reshape(b, sk, hkv, groups, d).sum(3)
    dv = dv.reshape(b, sk, hkv, groups, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int | None = None,
                          scale: float | None = None) -> torch.Tensor:
    """Plain version of the kernel on any device: the kernel's masks
    (``NEG_INF``, finite) and denominator floor (``L_FLOOR``) on the whole
    score matrix at once, in f32, cast to q's dtype."""
    _check(q, k, v, window)
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    kf = k.float().repeat_interleave(h // hkv, dim=2)
    vf = v.float().repeat_interleave(h // hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    s = torch.where(_mask(sq, sk, causal, window, q.device), s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = torch.clamp(p.sum(-1, keepdim=True), min=L_FLOOR)
    out = torch.einsum("bhqk,bkhd->bhqd", p, vf) / l
    return out.transpose(1, 2).to(q.dtype)
