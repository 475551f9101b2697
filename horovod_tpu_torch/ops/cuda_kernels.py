"""Hand-written CUDA kernels and their plain-PyTorch twins.

Counterparts of ``horovod_tpu/ops/pallas_kernels.py``:

* the wire section (int8 block quantize / dequantize, fused quantize + pack
  for the int8 and int4 wires), CUDA C++ in ``csrc/wire_quant.cu``;
* the Adasum pairwise combine (``adasum_combine_pairs``), CUDA C++ in
  ``csrc/adasum.cu``.

Each wrapper here

* checks device, dtype, shape and strides and raises on what the kernel
  does not take;
* runs the plain twin (same module, ``*_plain``) for a tensor on the CPU,
  and only then;
* launches the kernel for a CUDA tensor, on the current stream, and raises
  if the build or the launch fails -- never a fallback to the twin;
* adds one to its ``launches`` counter per kernel launch.

The quantize formula, shared bit for bit by kernel and twin: per row,
``scale = absmax * f32(1/qmax)``, ``safe = scale if scale > 0 else 1``,
``q = int8(clip(round_half_even(x / safe), -qmax, qmax))``. A packed row is
``[payload | 4 little-endian bytes of the f32 scale]``; int4 payload bytes
hold half-split nibbles, ``byte j = (q[j] & 0xF) | (q[j + B/2] << 4)``.

The Adasum combine of a pair ``(a, b)``: ``dot``, ``|a|^2`` and ``|b|^2``
reduced in f32, then ``(1 - dot/(2|a|^2)) a + (1 - dot/(2|b|^2)) b`` in the
input dtype, a coefficient being 1 where its norm is 0. Kernel and twin
reduce in different orders, so they agree to a tolerance, not to the bit
(``chip_smoke.py`` states it).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

PACK_SCALE_BYTES = 4  # one f32 scale per block row, as raw bytes
INT8_QMAX = 127.0
INT4_QMAX = 7.0

_FLOATS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# C function -> (library of csrc/<library>.cu, argument types, result type)
_SIGNATURES = {
    "hvd_int8_quantize": ("wire_quant", [_P, _I, _P, _P, _I64, _I, _P], _I),
    "hvd_int8_dequantize": ("wire_quant", [_P, _P, _P, _I64, _I, _P], _I),
    "hvd_int8_quantize_pack": ("wire_quant", [_P, _I, _P, _I64, _I, _P], _I),
    "hvd_int4_quantize_pack": ("wire_quant", [_P, _I, _P, _I64, _I, _P], _I),
    "hvd_adasum_combine": ("adasum", [_P, _I64, _P, _I64, _I, _P, _I64, _I64,
                                      _P, _P], _I),
    "hvd_adasum_scratch_floats": ("adasum", [_I64, _I64, _I], _I64),
}


def _kernel(name: str):
    library, argtypes, restype = _SIGNATURES[name]
    lib = _build.load(library)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = restype
        lib.hvd_cuda_error_string.argtypes = [ctypes.c_int]
        lib.hvd_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def _launch(name: str, device: torch.device, *args) -> None:
    lib, fn = _kernel(name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        msg = lib.hvd_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} ({err})")


def _check_2d(t: torch.Tensor, what: str, dtypes,
              strided_rows: bool = False) -> None:
    """``strided_rows``: rows may lie at any stride; only the elements of
    a row must be contiguous."""
    if not isinstance(t, torch.Tensor) or t.dim() != 2:
        raise ValueError(f"{what}: expected a 2-D tensor, got "
                         f"{getattr(t, 'shape', type(t))}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what}: dtype {t.dtype} not in "
                        f"{sorted(str(d) for d in dtypes)}")
    if strided_rows:
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError(f"{what}: the elements of a row must be "
                             f"contiguous (strides {t.stride()})")
    elif not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")


def _check_block(block: int, what: str, even: bool = False) -> None:
    if block < 2 or (even and block % 2):
        raise ValueError(f"{what}: block {block} must be >= 2"
                         + (" and even (two values per byte)" if even else ""))


# ------------------------------------------------------------ plain twins
def quant_rows(x2: torch.Tensor, qmax: float):
    """The shared quantize formula: ([rows, B] int8, [rows, 1] f32)."""
    xf = x2.float()
    absmax = xf.abs().amax(dim=1, keepdim=True)  # propagates NaN
    scale = absmax * (1.0 / qmax)                # f32 multiply by f32(1/qmax)
    safe = torch.where(scale > 0.0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xf / safe), -qmax, qmax).to(torch.int8)
    return q, scale


def _scale_bytes(scale: torch.Tensor) -> torch.Tensor:
    return scale.contiguous().view(torch.int8)  # [rows, 1] f32 -> [rows, 4]


def int8_quantize_2d_plain(x2):
    """[rows, B] float -> ([rows, B] int8, [rows, 1] f32 scales)."""
    return quant_rows(x2, INT8_QMAX)


def int8_dequantize_2d_plain(q2, s2):
    """([rows, B] int8, [rows, 1] f32) -> [rows, B] f32."""
    return q2.float() * s2


def int8_quantize_pack_2d_plain(x2):
    """[rows, B] float -> [rows, B + 4] int8 packed rows."""
    q, scale = quant_rows(x2, INT8_QMAX)
    return torch.cat([q, _scale_bytes(scale)], dim=1)


def int4_quantize_pack_2d_plain(x2):
    """[rows, B] float, B even -> [rows, B/2 + 4] int8 packed rows."""
    q, scale = quant_rows(x2, INT4_QMAX)
    half = x2.shape[1] // 2
    b = (q[:, :half] & 15) | (q[:, half:] << 4)
    return torch.cat([b, _scale_bytes(scale)], dim=1)


def adasum_combine_pairs_plain(a, b):
    """[m, n] x 2 float -> [m, n] in the input dtype: pair ``i`` combines
    ``a[i]`` with ``b[i]``; the zero-norm guard of the reference executor's
    combine (a coefficient is 1 where its norm is 0)."""
    af, bf = a.float(), b.float()
    dot = torch.sum(af * bf, dim=1, keepdim=True)

    def coef(norm):
        one = torch.ones_like(norm)
        safe = torch.where(norm == 0, one, norm)
        return torch.where(norm == 0, one, 1.0 - dot / (2.0 * safe))

    ac = coef(torch.sum(af * af, dim=1, keepdim=True))
    bc = coef(torch.sum(bf * bf, dim=1, keepdim=True))
    return (ac * af + bc * bf).to(a.dtype)


# -------------------------------------------------------------- wrappers
def int8_quantize_2d(x2):
    """[rows, B] f32/bf16/f16 -> ([rows, B] int8, [rows, 1] f32 scales).
    Replaces ``pallas_kernels.int8_quantize_2d``."""
    _check_2d(x2, "int8_quantize_2d", _FLOATS)
    rows, block = x2.shape
    _check_block(block, "int8_quantize_2d")
    if x2.device.type == "cpu":
        return int8_quantize_2d_plain(x2)
    q = torch.empty((rows, block), dtype=torch.int8, device=x2.device)
    s = torch.empty((rows, 1), dtype=torch.float32, device=x2.device)
    if rows:
        _launch("hvd_int8_quantize", x2.device, x2.data_ptr(),
                _FLOATS[x2.dtype], q.data_ptr(), s.data_ptr(), rows, block)
        int8_quantize_2d.launches += 1
    return q, s


def int8_dequantize_2d(q2, s2):
    """([rows, B] int8, [rows, 1] f32) -> [rows, B] f32.
    Replaces ``pallas_kernels.int8_dequantize_2d``."""
    _check_2d(q2, "int8_dequantize_2d", (torch.int8,))
    _check_2d(s2, "int8_dequantize_2d scales", (torch.float32,))
    rows, block = q2.shape
    if tuple(s2.shape) != (rows, 1) or s2.device != q2.device:
        raise ValueError(f"int8_dequantize_2d: scales {tuple(s2.shape)} on "
                         f"{s2.device} do not match payload "
                         f"{tuple(q2.shape)} on {q2.device}")
    if q2.device.type == "cpu":
        return int8_dequantize_2d_plain(q2, s2)
    y = torch.empty((rows, block), dtype=torch.float32, device=q2.device)
    if rows and block:
        _launch("hvd_int8_dequantize", q2.device, q2.data_ptr(), s2.data_ptr(),
                y.data_ptr(), rows, block)
        int8_dequantize_2d.launches += 1
    return y


def int8_quantize_pack_2d(x2):
    """[rows, B] f32/bf16/f16 -> [rows, B + 4] int8 packed rows.
    Replaces ``pallas_kernels.int8_quantize_pack_2d``."""
    _check_2d(x2, "int8_quantize_pack_2d", _FLOATS)
    rows, block = x2.shape
    _check_block(block, "int8_quantize_pack_2d")
    if x2.device.type == "cpu":
        return int8_quantize_pack_2d_plain(x2)
    p = torch.empty((rows, block + PACK_SCALE_BYTES), dtype=torch.int8,
                    device=x2.device)
    if rows:
        _launch("hvd_int8_quantize_pack", x2.device, x2.data_ptr(),
                _FLOATS[x2.dtype], p.data_ptr(), rows, block)
        int8_quantize_pack_2d.launches += 1
    return p


def int4_quantize_pack_2d(x2):
    """[rows, B] f32/bf16/f16, B even -> [rows, B/2 + 4] int8 packed rows.
    Replaces ``pallas_kernels.int4_quantize_pack_2d``."""
    _check_2d(x2, "int4_quantize_pack_2d", _FLOATS)
    rows, block = x2.shape
    _check_block(block, "int4_quantize_pack_2d", even=True)
    if x2.device.type == "cpu":
        return int4_quantize_pack_2d_plain(x2)
    p = torch.empty((rows, block // 2 + PACK_SCALE_BYTES), dtype=torch.int8,
                    device=x2.device)
    if rows:
        _launch("hvd_int4_quantize_pack", x2.device, x2.data_ptr(),
                _FLOATS[x2.dtype], p.data_ptr(), rows, block)
        int4_quantize_pack_2d.launches += 1
    return p


def adasum_combine_pairs(a, b):
    """[m, n] x 2 f32/bf16/f16 -> [m, n] in the input dtype: pair ``i``
    combines ``a[i]`` with ``b[i]``. Replaces
    ``pallas_kernels.adasum_combine_pairs``; unlike it, any ``n`` is taken
    (no lane alignment, so nothing is padded). Rows may be strided views
    (``buf[0::2]``, ``buf[1::2]`` of a tree level): only the elements of a
    row must be contiguous. One launch per call, two CUDA kernels (reduce,
    then apply)."""
    _check_2d(a, "adasum_combine_pairs a", _FLOATS, strided_rows=True)
    _check_2d(b, "adasum_combine_pairs b", _FLOATS, strided_rows=True)
    if a.shape != b.shape or a.dtype != b.dtype or a.device != b.device:
        raise ValueError(f"adasum_combine_pairs: a {tuple(a.shape)} "
                         f"{a.dtype} on {a.device} does not match b "
                         f"{tuple(b.shape)} {b.dtype} on {b.device}")
    m, n = a.shape
    if a.device.type == "cpu":
        return adasum_combine_pairs_plain(a, b)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m and n:
        dt = _FLOATS[a.dtype]
        scratch = torch.empty(
            (_kernel("hvd_adasum_scratch_floats")[1](m, n, dt),),
            dtype=torch.float32, device=a.device)
        _launch("hvd_adasum_combine", a.device, a.data_ptr(), a.stride(0),
                b.data_ptr(), b.stride(0), dt, out.data_ptr(), m, n,
                scratch.data_ptr())
        adasum_combine_pairs.launches += 1
    return out


WRAPPERS = (int8_quantize_2d, int8_dequantize_2d, int8_quantize_pack_2d,
            int4_quantize_pack_2d, adasum_combine_pairs)
for _w in WRAPPERS:
    _w.launches = 0


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {w.__name__: w.launches for w in WRAPPERS}


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0


# ------------------------------------------------------------ unpacking
def int8_unpack(p2):
    """[rows, B + 4] packed int8 -> ([rows, B] int8, [rows, 1] f32).
    Layout surgery only: a slice and a bit view."""
    block = p2.shape[1] - PACK_SCALE_BYTES
    q = p2[:, :block]
    scales = p2[:, block:].contiguous().view(torch.float32)
    return q, scales


def int4_unpack(p2):
    """[rows, B/2 + 4] packed int4 -> ([rows, B] int8, [rows, 1] f32).
    Sign extension by arithmetic shifts on int8: ``(b << 4) >> 4`` for the
    low nibble, ``b >> 4`` for the high one."""
    half = p2.shape[1] - PACK_SCALE_BYTES
    b = p2[:, :half]
    q = torch.cat([(b << 4) >> 4, b >> 4], dim=1)
    scales = p2[:, half:].contiguous().view(torch.float32)
    return q, scales
