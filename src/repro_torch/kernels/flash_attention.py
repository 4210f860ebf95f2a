"""Prefill flash attention: the hand-written Hopper kernels of K4
(``csrc/flash_attention.cu``, replacing the JAX package's Pallas
``flash_attention``) and their wrapper.  bf16 runs on the tensor cores
(``mma.sync`` m16n8k16, fp32 accumulators, k/v tiles copied
asynchronously); fp32 on the CUDA cores, in full fp32.

Its plain version is ``ops.flash_attention_torch`` (the JAX
``flash_attention_jnp`` mirror, chunked online softmax in plain torch).
The wrapper takes it for a tensor that lies on the CPU; for a CUDA tensor
it launches the kernel or raises, with no fallback.  ``LAUNCHES
["flash_attention"]`` counts the launches.

Rows that see no key (only ``q_offset`` or window edge cases make them;
every model row sees itself) follow the reference's finite ``NEG_INF``: the
kernel returns the mean of the v rows of the in-range keys of the key
tiles its block visits (64 keys; 32 in the bf16 kernel at D 192), or 0
when the block visits none.  Like the reference's, that value depends on
the tile size, so it differs from the plain version's; it is finite.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.binding import DTYPE_CODE, LAUNCHES, check, ptr

ROWS = 128          # (q position, q head) rows per kernel block
# (q/k head dim, v head dim) pairs built: the dense families' (h2o-danube's
# 120 among them) and deepseek-v2's MLA prefill ([nope 128 | rope 64] q/k,
# v 128); the kernels' shared memory at each is checked against Hopper's
# 227 KB when they compile
HEAD_DIMS = ((64, 64), (120, 120), (128, 128), (192, 128))


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    logit_cap: float = 0.0, scale: float | None = None,
                    q_offset: int = 0):
    """K4.  q (B, Sq, Hq, D), k (B, Sk, Hkv, D), v (B, Sk, Hkv, Dv) ->
    (B, Sq, Hq, Dv) in q's dtype, (D, Dv) one of ``HEAD_DIMS``.  fp32
    online softmax; the soft-cap ``logit_cap * tanh(s / logit_cap)`` comes
    before the causal / window mask; ``scale`` defaults to ``D ** -0.5``;
    query row i sits at position ``q_offset + i``."""
    if q.device.type == "cpu":
        from repro_torch.kernels.ops import flash_attention_torch
        return flash_attention_torch(q, k, v, causal=causal, window=window,
                                     logit_cap=logit_cap, scale=scale,
                                     q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    from repro_torch.kernels import build
    B, Sq, Hq, D = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if q.dtype not in DTYPE_CODE:
        raise ValueError(f"flash_attention: dtype {q.dtype} not supported "
                         "(float32 | bfloat16)")
    if (D, Dv) not in HEAD_DIMS:
        raise ValueError(f"flash_attention: (head_dim, v head_dim) "
                         f"{(D, Dv)} not supported {HEAD_DIMS}")
    if Hq % Hkv or Hq // Hkv > ROWS:
        raise ValueError(f"flash_attention: Hq {Hq} not a multiple of Hkv "
                         f"{Hkv} with at most {ROWS} q heads per kv head")
    if Sk < 1:
        raise ValueError("flash_attention: no keys")
    dev = q.device
    check("q", q, dtype=q.dtype, shape=(B, Sq, Hq, D), device=dev,
          vector=True)
    check("k", k, dtype=q.dtype, shape=(B, Sk, Hkv, D), device=dev,
          vector=True)
    check("v", v, dtype=q.dtype, shape=(B, Sk, Hkv, Dv), device=dev,
          vector=True)
    out = torch.empty((B, Sq, Hq, Dv), dtype=q.dtype, device=dev)
    if B == 0 or Sq == 0:
        return out
    if scale is None:
        scale = D ** -0.5
    err = build.library().flash_attention_fwd(
        ptr(q), ptr(k), ptr(v), ptr(out), B, Sq, Sk, Hq, Hkv, D, Dv,
        ROWS // (Hq // Hkv), int(causal), int(window), int(q_offset),
        float(logit_cap), float(scale), DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: CUDA error {err}")
    LAUNCHES["flash_attention"] += 1
    return out


def occupancy(head_dim: int, v_head_dim: int, dtype) -> dict:
    """The kernel ``flash_attention`` launches for a (D, Dv, dtype) form, as
    the card runs it: blocks per SM, dynamic shared memory bytes and
    registers a thread."""
    from repro_torch.kernels import build
    info = (ctypes.c_int * 3)()
    err = build.library().flash_attention_occupancy(
        head_dim, v_head_dim, DTYPE_CODE[dtype], info)
    if err != 0:
        raise RuntimeError(f"flash_attention_occupancy: CUDA error {err}")
    return dict(blocks_per_sm=info[0], smem_bytes=info[1],
                registers=info[2])
