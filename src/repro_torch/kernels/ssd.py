"""CUDA kernel wrappers: the SSD heads' elementwise work around the scan.

The Mamba-2 style heads of the hybrid blocks (`models/lm/ssm.py`) run
between their projections and their output projection as three launches
forward, `ssd_front` (the causal depthwise conv, its SiLU, the decay and
the scan's inputs), the `wkv6` scan and `ssd_back` (the scan's diagonal,
the D skip, the gate and the RMSNorm), and four backward: `ssd_back_bwd`,
`wkv6_bwd`, then `ssd_front_bwd`, which also launches the reduction of
the weights' per-tile gradient partials. The kernels are
`repro_torch/csrc/ssd.cu` and `ssd_bwd.cu`; their plain versions are
`ref.ssd_front_ref`, `ssd_back_ref`, `ssd_back_bwd_ref` and
`ssd_front_bwd_ref`, whose docstrings give the arithmetic and the shapes.
They replace no TPU kernel: the reference leaves this work to XLA.

The kernels are built for the widths of every registered configuration
with SSD heads (hymba-1.5b and its reduced copy): head_dim 64, state 16,
a conv of 4 taps and d_inner (E) a multiple of 64 up to 4,096; any
other width raises. Model-dtype tensors are f32 or bf16, one dtype
throughout; the rows (xz, the projections, the scan's tensors) are
dense, and the per-client weights need only dense rows.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.stream import current_stream

HEAD_DIM = 64
STATE_DIM = 16
CONV_K = 4
MAX_D_INNER = 4096
# Rows of one tile (`csrc/ssd.cuh`): the conv kernels' and the norm
# kernels'; the weights' gradient partials are kept per tile.
ROWS_FRONT = 64
ROWS_BACK = 16
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_WEIGHTS = ("conv_w", "conv_b", "dt_b", "a_log", "d_skip", "out_norm")


def _tiles(G: int, B: int, T: int, rows: int) -> int:
    return G * B * -(-T // rows)


def _dims(xz: torch.Tensor, bt: torch.Tensor, seq_len: int, head_dim: int,
          what: str) -> tuple[int, int, int, int, int]:
    """Raise on widths the kernels are not built for; (G, B, T, E, H)."""
    G, n, E2 = xz.shape
    E = E2 // 2
    if head_dim != HEAD_DIM or bt.shape[-1] != STATE_DIM or E2 % 2 \
            or E % HEAD_DIM or not 0 < E <= MAX_D_INNER \
            or seq_len < 1 or n % seq_len:
        raise ValueError(
            f"{what}: the SSD kernels take head_dim {HEAD_DIM}, state "
            f"{STATE_DIM}, a conv of {CONV_K} taps and d_inner a multiple "
            f"of {HEAD_DIM} up to {MAX_D_INNER} (hymba-1.5b: 3200, its "
            f"reduced copy: 512) over whole sequences; got head_dim "
            f"{head_dim}, state {bt.shape[-1]}, d_inner {E2 / 2:g}, "
            f"{n} rows of {seq_len}")
    return G, n // seq_len, seq_len, E, E // head_dim


def _check(what: str, dtype: torch.dtype, device: torch.device,
           model=(), f32=(), weights=()) -> None:
    """Device, dtype and layout of every tensor: `model` and `weights` in
    the model's dtype, `f32` in float32; rows dense and 16-byte aligned,
    each weight dense after its client axis."""
    if dtype not in _DTYPES:
        raise TypeError(f"{what}: model dtype must be float32 or bfloat16, "
                        f"got {dtype}")
    for kind, named in (("model", model), ("f32", f32),
                        ("weights", weights)):
        want = torch.float32 if kind == "f32" else dtype
        for name, t in named:
            if t.device != device:
                raise ValueError(f"{what}: {name} must be on {device}, got "
                                 f"{t.device}")
            if t.dtype != want:
                raise TypeError(f"{what}: {name} must be {want}, got "
                                f"{t.dtype}")
            if kind == "weights":
                inner = t[0] if t.shape[0] else t
                if not inner.is_contiguous():
                    raise ValueError(f"{what}: {name} must be dense after "
                                     "its client axis")
            elif not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(f"{what}: {name} must be dense and 16-byte "
                                 "aligned")


def _strides(**weights) -> ctypes.Array:
    """Client-axis strides of the six weights (0 for those not passed)."""
    return (ctypes.c_int64 * 6)(*(
        weights[n].stride(0) if n in weights else 0 for n in _WEIGHTS))


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def ssd_front(xz, dt_raw, bt, ct, conv_w, conv_b, dt_b, a_log, conv_tail,
              seq_len: int, head_dim: int):
    """Launch the front kernel -> (xh, r, v, k, dt, logw), as
    `ref.ssd_front_ref`."""
    G, B, T, E, H = _dims(xz, bt, seq_len, head_dim, "ssd_front")
    dev, dtype = xz.device, xz.dtype
    tail = None if conv_tail is None else conv_tail.contiguous()
    _check("ssd_front", dtype, dev,
           model=[("xz", xz), ("dt_raw", dt_raw), ("bt", bt), ("ct", ct)]
           + ([] if tail is None else [("conv_tail", tail)]),
           weights=[("conv_w", conv_w), ("conv_b", conv_b), ("dt_b", dt_b),
                    ("a_log", a_log)])
    n, f32 = B * T, dict(dtype=torch.float32, device=dev)
    xh = torch.empty((G, n, E), dtype=dtype, device=dev)
    r = torch.empty((G * B, T, H, STATE_DIM), **f32)
    v = torch.empty((G * B, T, H, HEAD_DIM), **f32)
    k = torch.empty((G, n, STATE_DIM), **f32)
    dt, logw = (torch.empty((G, n, H), **f32) for _ in range(2))
    fn = build.entry(f"ssd_front_{_DTYPES[dtype]}")
    build.check(fn(xz.data_ptr(), dt_raw.data_ptr(), bt.data_ptr(),
                   ct.data_ptr(), conv_w.data_ptr(), conv_b.data_ptr(),
                   dt_b.data_ptr(), a_log.data_ptr(), _ptr(tail),
                   _strides(conv_w=conv_w, conv_b=conv_b, dt_b=dt_b,
                            a_log=a_log),
                   xh.data_ptr(), r.data_ptr(), v.data_ptr(), k.data_ptr(),
                   dt.data_ptr(), logw.data_ptr(), G, B, T, E, H,
                   dev.index, current_stream(dev.index)), "ssd_front")
    return xh, r, v, k, dt, logw


def ssd_back(o, xh, xz, bt, ct, dt, d_skip, out_norm, head_dim: int):
    """Launch the back kernel on the scan's output o (G B, T, H, 64) ->
    (y, rstd), as `ref.ssd_back_ref`."""
    G, B, T, E, H = _dims(xz, bt, o.shape[1], head_dim, "ssd_back")
    n, dev, dtype = B * T, xz.device, xz.dtype
    _check("ssd_back", dtype, dev,
           model=[("xh", xh), ("xz", xz), ("bt", bt), ("ct", ct)],
           f32=[("o", o), ("dt", dt)],
           weights=[("d_skip", d_skip), ("out_norm", out_norm)])
    y = torch.empty((G, n, E), dtype=dtype, device=dev)
    rstd = torch.empty((G, n), dtype=torch.float32, device=dev)
    fn = build.entry(f"ssd_back_{_DTYPES[dtype]}")
    build.check(fn(o.data_ptr(), xh.data_ptr(), xz.data_ptr(), bt.data_ptr(),
                   ct.data_ptr(), dt.data_ptr(), d_skip.data_ptr(),
                   out_norm.data_ptr(),
                   _strides(d_skip=d_skip, out_norm=out_norm), y.data_ptr(),
                   rstd.data_ptr(), G, B, T, E, H, dev.index,
                   current_stream(dev.index)), "ssd_back")
    return y, rstd


def ssd_back_bwd(dy, o, xh, xz, bt, ct, dt, d_skip, out_norm, rstd,
                 head_dim: int, dxz: torch.Tensor):
    """Launch the back kernel's backward: dz into dxz[..., E:] -> (du, p2,
    the per-tile partials of out_norm's gradient, which `ssd_front_bwd`
    reduces); as `ref.ssd_back_bwd_ref`."""
    G, B, T, E, H = _dims(xz, bt, o.shape[1], head_dim, "ssd_back_bwd")
    n, dev, dtype = B * T, xz.device, xz.dtype
    _check("ssd_back_bwd", dtype, dev,
           model=[("dy", dy), ("xh", xh), ("xz", xz), ("bt", bt),
                  ("ct", ct), ("dxz", dxz)],
           f32=[("o", o), ("dt", dt), ("rstd", rstd)],
           weights=[("d_skip", d_skip), ("out_norm", out_norm)])
    f32 = dict(dtype=torch.float32, device=dev)
    du = torch.empty((G, n, E), **f32)
    p2 = torch.empty((G, n, H), **f32)
    norm_part = torch.empty((_tiles(G, B, T, ROWS_BACK), E), **f32)
    fn = build.entry(f"ssd_back_bwd_{_DTYPES[dtype]}")
    build.check(fn(dy.data_ptr(), o.data_ptr(), xh.data_ptr(),
                   xz.data_ptr(), bt.data_ptr(), ct.data_ptr(),
                   dt.data_ptr(), d_skip.data_ptr(), out_norm.data_ptr(),
                   _strides(d_skip=d_skip, out_norm=out_norm),
                   rstd.data_ptr(), du.data_ptr(), dxz.data_ptr(),
                   p2.data_ptr(), norm_part.data_ptr(), G, B, T, E, H,
                   dev.index, current_stream(dev.index)), "ssd_back_bwd")
    return du, p2, norm_part


def ssd_front_bwd(du, dv, dr, dk, dlogw, p2, xz, dt_raw, bt, ct, conv_w,
                  conv_b, dt_b, a_log, d_skip, conv_tail, dt, logw,
                  seq_len: int, head_dim: int, dxz: torch.Tensor,
                  norm_part: torch.Tensor):
    """Launch the front kernel's backward and the weights' reduction: dxs
    into dxz[..., :E] -> (ddt_raw, dbt, dct, dconv_w, dconv_b, ddt_b,
    da_log, dd_skip, dout_norm, dconv_tail or None); as
    `ref.ssd_front_bwd_ref`, with out_norm's gradient from
    `ssd_back_bwd`'s partials."""
    G, B, T, E, H = _dims(xz, bt, seq_len, head_dim, "ssd_front_bwd")
    dev, dtype = xz.device, xz.dtype
    tail = None if conv_tail is None else conv_tail.contiguous()
    _check("ssd_front_bwd", dtype, dev,
           model=[("xz", xz), ("dt_raw", dt_raw), ("bt", bt), ("ct", ct),
                  ("dxz", dxz)]
           + ([] if tail is None else [("conv_tail", tail)]),
           f32=[("du", du), ("dv", dv), ("dr", dr), ("dk", dk),
                ("dlogw", dlogw), ("p2", p2), ("dt", dt), ("logw", logw),
                ("norm_part", norm_part)],
           weights=[("conv_w", conv_w), ("conv_b", conv_b), ("dt_b", dt_b),
                    ("a_log", a_log), ("d_skip", d_skip)])
    n, model = B * T, dict(dtype=dtype, device=dev)
    ddt_raw = torch.empty((G, n, H), **model)
    dbt, dct = (torch.empty((G, n, STATE_DIM), **model) for _ in range(2))
    dtail = None if tail is None else torch.empty_like(tail)
    dconv_w = torch.empty((G, CONV_K, E), **model)
    dconv_b, dout_norm = (torch.empty((G, E), **model) for _ in range(2))
    ddt_b, da_log, dd_skip = (torch.empty((G, H), **model) for _ in range(3))
    tiles = _tiles(G, B, T, ROWS_FRONT)
    f32 = dict(dtype=torch.float32, device=dev)
    conv_part = torch.empty((tiles, CONV_K + 1, E), **f32)
    head_part = torch.empty((tiles, 3, H), **f32)
    fn = build.entry(f"ssd_front_bwd_{_DTYPES[dtype]}")
    build.check(fn(du.data_ptr(), dv.data_ptr(), dr.data_ptr(),
                   dk.data_ptr(), dlogw.data_ptr(), p2.data_ptr(),
                   xz.data_ptr(), _ptr(tail), dt_raw.data_ptr(),
                   bt.data_ptr(), ct.data_ptr(), conv_w.data_ptr(),
                   conv_b.data_ptr(), dt_b.data_ptr(), a_log.data_ptr(),
                   d_skip.data_ptr(),
                   _strides(conv_w=conv_w, conv_b=conv_b, dt_b=dt_b,
                            a_log=a_log, d_skip=d_skip),
                   dt.data_ptr(), logw.data_ptr(), norm_part.data_ptr(),
                   dxz.data_ptr(), ddt_raw.data_ptr(), dbt.data_ptr(),
                   dct.data_ptr(), _ptr(dtail), dconv_w.data_ptr(),
                   dconv_b.data_ptr(), ddt_b.data_ptr(), da_log.data_ptr(),
                   dd_skip.data_ptr(), dout_norm.data_ptr(),
                   conv_part.data_ptr(), head_part.data_ptr(), G, B, T, E, H,
                   dev.index, current_stream(dev.index)), "ssd_front_bwd")
    return (ddt_raw, dbt, dct, dconv_w, dconv_b, ddt_b, da_log, dd_skip,
            dout_norm, dtail)
