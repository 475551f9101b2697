"""Wire-compression kernels and their plain-PyTorch twins.

Counterpart of the wire section of ``horovod_tpu/ops/pallas_kernels.py``
(int8 block quantize / dequantize, fused quantize + pack for the int8 and
int4 wires). The kernels are CUDA C++ in ``csrc/wire_quant.cu``; each
wrapper here

* checks device, dtype, shape and contiguity and raises on what the kernel
  does not take;
* runs the plain twin (same module, ``*_plain``) for a tensor on the CPU,
  and only then;
* launches the kernel for a CUDA tensor, on the current stream, and raises
  if the launch fails -- never a fallback to the twin;
* adds one to its ``launches`` counter per kernel launch.

The formula, shared bit for bit by kernel and twin: per row,
``scale = absmax * f32(1/qmax)``, ``safe = scale if scale > 0 else 1``,
``q = int8(clip(round_half_even(x / safe), -qmax, qmax))``. A packed row is
``[payload | 4 little-endian bytes of the f32 scale]``; int4 payload bytes
hold half-split nibbles, ``byte j = (q[j] & 0xF) | (q[j + B/2] << 4)``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

PACK_SCALE_BYTES = 4  # one f32 scale per block row, as raw bytes
INT8_QMAX = 127.0
INT4_QMAX = 7.0

_FLOATS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SIGNATURES = {
    "hvd_int8_quantize": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                          ctypes.c_void_p],
    "hvd_int8_dequantize": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_int64, ctypes.c_int, ctypes.c_void_p],
    "hvd_int8_quantize_pack": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_int64, ctypes.c_int, ctypes.c_void_p],
    "hvd_int4_quantize_pack": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_int64, ctypes.c_int, ctypes.c_void_p],
}


def _kernel(name: str):
    lib = _build.load("wire_quant")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
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


def _check_2d(t: torch.Tensor, what: str, dtypes) -> None:
    if not isinstance(t, torch.Tensor) or t.dim() != 2:
        raise ValueError(f"{what}: expected a 2-D tensor, got "
                         f"{getattr(t, 'shape', type(t))}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what}: dtype {t.dtype} not in "
                        f"{sorted(str(d) for d in dtypes)}")
    if not t.is_contiguous():
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


WRAPPERS = (int8_quantize_2d, int8_dequantize_2d, int8_quantize_pack_2d,
            int4_quantize_pack_2d)
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
