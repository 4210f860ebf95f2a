"""The roofline terms of a compiled step, counted from the config: the
port's counterpart of ``repro.launch.hloparse``.

The JAX package lowers each step to HLO and parses it
(``hloparse.analyze``): the FLOPs of every ``dot``, an HBM-traffic proxy
and the bytes of every collective, each multiplied through the loops'
trip counts.  The port lowers no HLO, so this module counts the same
terms from the model config and the step's shapes:

  * ``dot_flops`` — 2 x M x K x N of every matmul as the port's code
    computes it, which is also what JAX's code computes: the prefill's
    attention over the whole S x S score matrix (masked, not skipped),
    the decode step's over the whole ring of ``max_len`` slots (a
    windowed layer's ``min(max_len, window)``), the MoE's experts over
    their capacity buffers, the SSD scan as JAX runs it at that S, the
    head over every position of the prefill.  The tests hold these equal
    to JAX's ``hloparse.analyze(...)["dot_flops"]`` at smoke shapes.
  * ``hbm_bytes`` — an estimate, not a parse: the weights read once in
    ``cfg.dtype``, the decode cache read once and the new rows written,
    each matmul's output written once (the train step's figure is
    :func:`repro_torch.launch.train.train_step_cost`'s).
  * ``collective_bytes`` / ``collectives`` — 0 and empty: the port runs
    on one card (``runtime.sharding.ShardingRules.constrain`` refuses a
    mesh that would shard).

    from repro_torch.launch import stepcost
    stepcost.analyze(cfg, "decode", batch=8, seq=1, max_len=56)
"""
from __future__ import annotations

from typing import Any

from repro_torch.kernels import ops
from repro_torch.models import common
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _capacity
from repro_torch.models.ssm import conv_dim


class _Count:
    """Dot FLOPs and matmul output elements, summed."""

    def __init__(self):
        self.flops = 0.0
        self.outs = 0.0

    def mm(self, rows, k, n):
        self.flops += 2.0 * rows * k * n
        self.outs += float(rows) * n


def _attention(c: _Count, cfg: ModelConfig, B: int, T: int, keys: int):
    """One attention sublayer over ``T`` query rows a sequence against
    ``keys`` key rows: projections, scores, values, output projection.
    MLA's prefill (``keys`` > 1 query) expands the latent to per-head k and
    v; its decode (``T`` == 1) runs absorbed, scoring the latent rows."""
    d, rows = cfg.d_model, B * T
    if cfg.use_mla:
        H, dn, dr, dv = (cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim,
                         cfg.v_head_dim)
        r_kv, r_q = cfg.kv_lora_rank, cfg.q_lora_rank
        if r_q:
            c.mm(rows, d, r_q)
            c.mm(rows, r_q, H * (dn + dr))
        else:
            c.mm(rows, d, H * (dn + dr))
        c.mm(rows, d, r_kv + dr)
        if T == 1:                                   # absorbed decode
            c.mm(B * H, dn, r_kv)                    # q_nope W_uk
            c.mm(B * H, r_kv, keys)                  # q_abs . c_kv
            c.mm(B * H, dr, keys)                    # q_rope . k_rope
            c.mm(B * H, keys, r_kv)                  # p . c_kv
            c.mm(B * H, r_kv, dv)                    # W_uv
        else:
            c.mm(rows, r_kv, H * dn)
            c.mm(rows, r_kv, H * dv)
            c.mm(B * H * T, dn + dr, keys)
            c.mm(B * H * T, keys, dv)
        c.mm(rows, H * dv, d)
        return
    hd, hq, hkv = (cfg.resolved_head_dim, cfg.padded_q_heads,
                   cfg.padded_kv_heads)
    c.mm(rows, d, hq * hd)
    c.mm(rows, d, hkv * hd)
    c.mm(rows, d, hkv * hd)
    c.mm(B * hq * T, hd, keys)
    c.mm(B * hq * T, keys, hd)
    c.mm(rows, hq * hd, d)


def _ffn(c: _Count, cfg: ModelConfig, rows: int, moe: bool, d_ff: int):
    d = cfg.d_model
    if not moe:
        for _ in range(2 if cfg.gated_mlp else 1):
            c.mm(rows, d, d_ff)
        c.mm(rows, d_ff, d)
        return
    E, k, ff = cfg.n_experts, cfg.experts_per_token, cfg.resolved_moe_d_ff
    C = _capacity(cfg, k, rows, E)
    c.mm(rows, d, E)                                 # router
    c.mm(E * C, d, ff)
    c.mm(E * C, d, ff)
    c.mm(E * C, ff, d)
    if cfg.n_shared_experts:
        sff = cfg.resolved_shared_d_ff * cfg.n_shared_experts
        c.mm(rows, d, sff)
        c.mm(rows, d, sff)
        c.mm(rows, sff, d)


def _mamba(c: _Count, cfg: ModelConfig, B: int, S: int, decode: bool):
    """One Mamba2 layer: the in-projections, the scan (prefill: the
    sequential scan's readout up to 64 steps or for a ragged S, else the
    chunked scan's products, as ``ops.ssd`` picks under ``auto``; decode:
    the conv as one contraction over its window and the readout C h), the
    out-projection."""
    d, di, H = cfg.d_model, cfg.d_inner, cfg.resolved_ssm_heads
    P, N = cfg.ssm_head_dim, cfg.ssm_state
    GN = cfg.ssm_groups * N
    rows = B * S
    for n in (di, di, GN, GN, H):                    # z, x, B, C, dt
        c.mm(rows, d, n)
    Q = ops.DEFAULT_POLICY.ssd_chunk
    if decode:
        c.mm(B * conv_dim(cfg), cfg.conv_width, 1)   # the conv window
        c.mm(B * H * P, N, 1)                        # y = C h
    elif S <= 64 or S % Q:
        c.mm(B * S * H * P, N, 1)                    # y = C h, a step each
    else:
        # per chunk and head over B x Q rows: the scores C B^T, the band's
        # M x, the carried-in readout C h^T and the state update x^T (w B)
        nc = S // Q
        c.flops += 2.0 * B * H * Q * nc * (Q * N + Q * P + 2 * P * N)
        c.outs += float(B * S * H * P)
    c.mm(rows, di, d)


def _forward(cfg: ModelConfig, B: int, S: int, keys, decode: bool):
    """(dot FLOPs, matmul output elements) of one forward over B x S
    positions; ``keys(window)`` is the key rows a layer of that window
    attends over."""
    c = _Count()
    rows, d = B * S, cfg.d_model
    for _ in range(cfg.first_dense_layers):
        _attention(c, cfg, B, S, keys(cfg.sliding_window))
        _ffn(c, cfg, rows, False, cfg.dense_d_ff or cfg.d_ff)
    for _ in range(tfm.n_units(cfg)):
        for i in range(tfm.unit_size(cfg)):
            if cfg.uses_ssm:
                _mamba(c, cfg, B, S, decode)
            else:
                _attention(c, cfg, B, S, keys(cfg.window_for_layer(i)))
                _ffn(c, cfg, rows, cfg.uses_moe, cfg.d_ff)
        if tfm.is_hybrid(cfg):                       # the shared block
            c.mm(rows, 2 * d, d)
            _attention(c, cfg, B, S, keys(cfg.sliding_window))
            _ffn(c, cfg, rows, False, cfg.d_ff)
    for _ in range(max(cfg.n_codebooks, 1)):         # the head
        c.mm(rows, d, tfm.padded_vocab(cfg))
    return c.flops, c.outs


def _weight_bytes(cfg: ModelConfig) -> float:
    return float(cfg.param_count() * common.dt(cfg.dtype).itemsize)


def _cache_row_bytes(cfg: ModelConfig) -> tuple[float, float]:
    """(bytes of one cached position across all layers, bytes of the
    SSM state across all layers), in ``cfg.dtype`` (the state fp32)."""
    es = common.dt(cfg.dtype).itemsize
    per_pos = per_state = 0.0
    n_attn = cfg.first_dense_layers
    if cfg.uses_ssm:
        n = cfg.n_layers - cfg.first_dense_layers
        per_state = n * (cfg.resolved_ssm_heads * cfg.ssm_head_dim
                         * cfg.ssm_state * 4
                         + (cfg.conv_width - 1) * conv_dim(cfg) * es)
        if tfm.is_hybrid(cfg):
            n_attn += tfm.n_units(cfg)
    else:
        n_attn += cfg.n_layers - cfg.first_dense_layers
    if cfg.use_mla:
        row = cfg.kv_lora_rank + cfg.rope_head_dim
    else:
        row = 2 * cfg.padded_kv_heads * cfg.resolved_head_dim
    per_pos = float(n_attn * row * es)
    return per_pos, per_state


def prefill_step_cost(cfg: ModelConfig, batch: int, seq: int) \
        -> tuple[float, float]:
    """(FLOPs, HBM bytes) of one prefill over ``batch`` x ``seq`` positions
    (``seq`` counts an image prefix too): ``make_prefill_step``'s
    forward, its attention over the S x S scores, the head over every
    position.  Bytes, an estimate: the weights once, each matmul's output
    once, the cache written once."""
    flops, outs = _forward(cfg, batch, seq, lambda w: seq, decode=False)
    es = common.dt(cfg.dtype).itemsize
    per_pos, per_state = _cache_row_bytes(cfg)
    nbytes = (_weight_bytes(cfg) + es * outs
              + batch * (seq * per_pos + per_state))
    return flops, float(nbytes)


def serve_step_cost(cfg: ModelConfig, batch: int, max_len: int) \
        -> tuple[float, float]:
    """(FLOPs, HBM bytes) of one ``make_serve_step`` decode step: one new
    token a sequence against the ring cache of ``max_len`` slots, each
    layer attending over its whole ring (``min(max_len, window)`` slots
    for a windowed layer), an SSM layer's O(1) recurrence.  Bytes, an
    estimate: the weights once, the whole ring and the SSM state read
    once and written back, each matmul's output once."""
    def keys(window):
        return min(max_len, window) if window > 0 else max_len

    flops, outs = _forward(cfg, batch, 1, keys, decode=True)
    es = common.dt(cfg.dtype).itemsize
    per_pos, per_state = _cache_row_bytes(cfg)
    nbytes = (_weight_bytes(cfg) + es * outs
              + batch * (max_len * per_pos + 2 * per_state + per_pos))
    return flops, float(nbytes)


def analyze(cfg: ModelConfig, kind: str, *, batch: int, seq: int,
            max_len: int = 0, n_micro: int = 1,
            moment_dtype: str = "float32") -> dict[str, Any]:
    """``hloparse.analyze``'s keys for one step of ``kind`` (train |
    prefill | decode): ``dot_flops``, ``hbm_bytes``, ``collective_bytes``
    (0 on one card) and ``collectives`` ({}).  ``seq`` is the train or
    prefill positions; a decode step reads a ring of ``max_len``."""
    if kind == "train":
        from repro_torch.launch.train import train_step_cost
        flops, nbytes = train_step_cost(cfg, batch, seq, n_micro=n_micro,
                                        moment_dtype=moment_dtype)
    elif kind == "prefill":
        flops, nbytes = prefill_step_cost(cfg, batch, seq)
    elif kind == "decode":
        flops, nbytes = serve_step_cost(cfg, batch, max_len or seq)
    else:
        raise ValueError(f"unknown step kind {kind!r} "
                         "(train | prefill | decode)")
    return {"dot_flops": float(flops), "hbm_bytes": float(nbytes),
            "collective_bytes": 0.0, "collectives": {}}
