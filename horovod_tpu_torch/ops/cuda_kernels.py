"""Hand-written CUDA kernels and their plain-PyTorch twins.

Counterparts of ``horovod_tpu/ops/pallas_kernels.py``:

* the wire section (int8 block quantize, also over many leaves in one
  launch, ``int8_quantize_2d_many``; dequantize; fused quantize + pack for
  the int8 and int4 wires), CUDA C++ in ``csrc/wire_quant.cu``;
* the Adasum pairwise combine (``adasum_combine_pairs``, also over many
  pair sets in one launch, ``adasum_combine_pairs_many``), CUDA C++ in
  ``csrc/adasum.cu``;
* flash attention, forward (``flash_attention_fwd``), the ring hop of
  sequence parallelism (``flash_attention_step``) and backward
  (``flash_attention_bwd``): for bf16 operands at D = 64 (the LM's heads,
  with bf16 or f32 gradients) on wgmma and TMA in
  ``csrc/flash_attention_sm90.cu``, for the rest CUDA C++ in
  ``csrc/flash_attention.cu``;
* the LayerNorm forward (``layer_norm_fwd``), ``csrc/layer_norm.cu``;
* the AdamW update over many leaves at once (``adamw_update``),
  ``csrc/adamw.cu``;
* the tiled matrix product of the fused matmul + reduce-scatter ring
  (``matmul_2d``, with its tile rule ``matmul_tiles``), ``csrc/matmul.cu``
  (bf16 on wgmma and TMA, with the Hopper helpers of ``csrc/sm90.cuh``).

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
(``chip_smoke.py`` states it). So do the attention and LayerNorm kernels;
the AdamW kernel rounds every operation as its twin does.
"""

from __future__ import annotations

import array
import ctypes

import torch
import torch.nn.functional as F

from . import _build

PACK_SCALE_BYTES = 4  # one f32 scale per block row, as raw bytes
INT8_QMAX = 127.0
INT4_QMAX = 7.0

_FLOATS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_F = ctypes.c_float
# C function -> (library of csrc/<library>.cu, argument types, result type)
_SIGNATURES = {
    "hvd_int8_quantize": ("wire_quant", [_P, _I, _P, _P, _I64, _I, _P], _I),
    "hvd_int8_quantize_many": ("wire_quant", [_P, _I, _I, _P, _P, _I, _P],
                               _I),
    "hvd_int8_table_leaves": ("wire_quant", [], _I),
    "hvd_int8_dequantize": ("wire_quant", [_P, _P, _P, _I64, _I, _P], _I),
    "hvd_int8_quantize_pack": ("wire_quant", [_P, _I, _P, _I64, _I, _P], _I),
    "hvd_int4_quantize_pack": ("wire_quant", [_P, _I, _P, _I64, _I, _P], _I),
    "hvd_adasum_combine": ("adasum", [_P, _I64, _P, _I64, _I, _P, _I64, _I64,
                                      _P, _I64, _P], _I),
    "hvd_adasum_combine_many": ("adasum", [_P, _I, _I, _P, _I64, _P], _I),
    "hvd_adasum_table_entries": ("adasum", [], _I),
    "hvd_adasum_pair_bytes": ("adasum", [], _I64),
    # the last argument of each launcher is the stream
    "hvd_flash_fwd": ("flash_attention", [_P, _P] + [_I] * 9
                      + [_F, _P, _P, _P], _I),
    "hvd_flash_bwd": ("flash_attention", [_P, _P] + [_I] * 10
                      + [_F, _F] + [_P] * 6, _I),
    "hvd_flash_step": ("flash_attention", [_P, _P] + [_I] * 9
                       + [_F, _P, _P, _P, _P], _I),
    # each operand as (pointer, sb, st, sh)
    "hvd_flash_fwd_sm90": ("flash_attention_sm90", [_P, _I64, _I64, _I64] * 3
                           + [_I] * 7 + [_F, _P, _P, _P], _I),
    "hvd_flash_step_sm90": ("flash_attention_sm90", [_P, _I64, _I64, _I64] * 3
                            + [_I] * 7 + [_F, _P, _P, _P, _P], _I),
    "hvd_flash_bwd_sm90": ("flash_attention_sm90", [_P, _I64, _I64, _I64] * 5
                           + [_I] * 7 + [_F, _F, _P, _P, _I, _I, _I]
                           + [_P] * 4, _I),
    "hvd_layer_norm_fwd": ("layer_norm", [_P, _I] + [_P] * 5
                           + [_I64, _I64, _F, _P], _I),
    "hvd_adamw": ("adamw", [_P, _I, _I, _I, _P] + [_F] * 9 + [_P], _I),
    "hvd_adamw_table_leaves": ("adamw", [], _I),
    "hvd_matmul": ("matmul", [_P, _P, _I, _I64, _I64, _I64, _P, _P], _I),
}


_loaded: dict = {}  # C function name -> (library, function), typed


def _kernel(name: str):
    got = _loaded.get(name)
    if got is not None:
        return got
    library, argtypes, restype = _SIGNATURES[name]
    lib = _build.load(library)
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = restype
    lib.hvd_cuda_error_string.argtypes = [ctypes.c_int]
    lib.hvd_cuda_error_string.restype = ctypes.c_char_p
    _loaded[name] = lib, fn
    return lib, fn


# The current stream of card ``index`` as a pointer-sized int, and the
# current card's index, without building Stream or device objects on every
# launch where torch allows.
_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
    lambda index: torch.cuda.current_stream(index).cuda_stream)
_current = getattr(torch._C, "_cuda_getDevice", None) or (
    lambda: torch.cuda.current_device())


def _launch(name: str, index: int, *args) -> None:
    """Launch on card ``index``'s current stream; the card is made current
    only when it is not already."""
    lib, fn = _loaded.get(name) or _kernel(name)
    if index == _current():
        err = fn(*args, _stream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, _stream(index))
    if err:
        msg = lib.hvd_cuda_error_string(err).decode()
        step = getattr(lib, "hvd_failure", None)
        if step is not None:  # the launcher says what it was doing
            step.restype = ctypes.c_char_p
            msg += f", {step().decode()}"
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


def int8_quantize_2d_many_plain(tensors, block: int):
    """Leaves of any shape -> ([R, block] int8, [R, 1] f32), R = the sum of
    ``ceil(n_i / block)``: each leaf flattened, zero-padded to whole rows
    and quantized by :func:`quant_rows`, its rows after the leaf before."""
    qs, ss = [], []
    for t in tensors:
        flat = t.reshape(-1)
        pad = (-flat.numel()) % block
        if pad:
            flat = F.pad(flat, (0, pad))
        q, s = quant_rows(flat.reshape(-1, block), INT8_QMAX)
        qs.append(q)
        ss.append(s)
    if not qs:
        return (torch.empty((0, block), dtype=torch.int8),
                torch.empty((0, 1), dtype=torch.float32))
    return torch.cat(qs), torch.cat(ss)


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


def adasum_combine_pairs_many_plain(pairs):
    """Pair sets ``(a_i, b_i)`` -> ``[adasum_combine_pairs_plain(a_i,
    b_i)]``, set by set."""
    return [adasum_combine_pairs_plain(a, b) for a, b in pairs]


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
        _launch("hvd_int8_quantize", x2.get_device(), x2.data_ptr(),
                _FLOATS[x2.dtype], q.data_ptr(), s.data_ptr(), rows, block)
        int8_quantize_2d.launches += 1
    return q, s


def int8_quantize_2d_many(tensors, block: int):
    """Leaves of any shape, f32/bf16/f16, each contiguous, all on one
    device -> ([R, block] int8, [R, 1] f32 scales), R = the sum of
    ``ceil(n_i / block)``. Leaf i's rows follow leaf i - 1's; elements past
    its end quantize as zeros (the padding of ``quantize_roundtrip``), and
    no padded copy is made. On the card one launch takes every leaf of a
    dtype, up to ``hvd_int8_table_leaves()`` leaves (one launch per table
    of that many); each launch counts in ``int8_quantize_2d.launches``."""
    tensors = list(tensors)
    _check_block(block, "int8_quantize_2d_many")
    dev = tensors[0].device if tensors else torch.device("cpu")
    for i, t in enumerate(tensors):
        # the common case in one test (a launch's host time is its cost)
        if not (isinstance(t, torch.Tensor) and t.dtype in _FLOATS
                and t.is_contiguous() and t.device == dev):
            _reject_leaf(i, t, dev)
    if dev.type == "cpu":
        return int8_quantize_2d_many_plain(tensors, block)
    if dev.type != "cuda":
        raise ValueError(f"int8_quantize_2d_many: unsupported device {dev}")
    groups, rows = {}, 0  # dtype -> (pointer, elements, first row) rows
    for t in tensors:
        n = t.numel()
        if n:
            groups.setdefault(t.dtype, array.array("q")).extend(
                (t.data_ptr(), n, rows))
        rows += -(-n // block)
    q = torch.empty((rows, block), dtype=torch.int8, device=dev)
    s = torch.empty((rows, 1), dtype=torch.float32, device=dev)
    if groups:
        per_table = 3 * _kernel("hvd_int8_table_leaves")[1]()
        for dtype, table in groups.items():
            for k in range(0, len(table), per_table):
                part = table[k:k + per_table]
                _launch("hvd_int8_quantize_many", dev.index,
                        part.buffer_info()[0], len(part) // 3,
                        _FLOATS[dtype], q.data_ptr(), s.data_ptr(), block)
                int8_quantize_2d.launches += 1
    return q, s


def _reject_leaf(i: int, t, dev) -> None:
    what = f"int8_quantize_2d_many leaf {i}"
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{what}: expected a tensor, got {type(t)}")
    if t.dtype not in _FLOATS:
        raise TypeError(f"{what}: dtype {t.dtype} not in "
                        f"{sorted(str(d) for d in _FLOATS)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")
    raise ValueError(f"{what}: on {t.device}, leaf 0 on {dev}")


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
        _launch("hvd_int8_dequantize", q2.get_device(), q2.data_ptr(),
                s2.data_ptr(), y.data_ptr(), rows, block)
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
        _launch("hvd_int8_quantize_pack", x2.get_device(), x2.data_ptr(),
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
        _launch("hvd_int4_quantize_pack", x2.get_device(), x2.data_ptr(),
                _FLOATS[x2.dtype], p.data_ptr(), rows, block)
        int4_quantize_pack_2d.launches += 1
    return p


def _adasum_pair_ok(a, b, dev) -> bool:
    """The common case of a pair set the kernel takes, in few attribute
    reads (a launch's host time is its cost); :func:`_reject_pair` names
    anything else."""
    try:
        return (a.dim() == 2 and a.dtype in _FLOATS and a.shape == b.shape
                and a.dtype == b.dtype and a.device == dev
                and b.device == dev
                and (a.shape[1] < 2 or a.stride(1) == b.stride(1) == 1))
    except AttributeError:
        return False


def _reject_pair(what: str, a, b, dev) -> None:
    _check_2d(a, f"{what} a", _FLOATS, strided_rows=True)
    _check_2d(b, f"{what} b", _FLOATS, strided_rows=True)
    if a.shape != b.shape or a.dtype != b.dtype or a.device != b.device:
        raise ValueError(f"{what}: a {tuple(a.shape)} {a.dtype} on "
                         f"{a.device} does not match b {tuple(b.shape)} "
                         f"{b.dtype} on {b.device}")
    raise ValueError(f"{what}: on {a.device}, the first pair set on {dev}")


_adasum_sizes: list = []    # [table entries, scratch bytes a pair]
_adasum_scratch: dict = {}  # (card, stream) -> zeroed pair slots (uint8)


def _adasum_limits() -> list:
    """[pair sets a launch's table holds, scratch bytes a pair], read from
    the library once."""
    if not _adasum_sizes:
        _adasum_sizes.extend((_kernel("hvd_adasum_table_entries")[1](),
                              _kernel("hvd_adasum_pair_bytes")[1]()))
    return _adasum_sizes


def _adasum_slots(index: int, pairs: int):
    """(pointer, bytes) of zeroed pair slots for ``pairs`` pairs on card
    ``index``'s current stream: one buffer a card and stream, kept zeroed
    by the kernel, grown when a call needs more."""
    need = pairs * _adasum_limits()[1]
    key = (index, _stream(index))
    buf = _adasum_scratch.get(key)
    if buf is None or buf.numel() < need:
        grown = 2 * buf.numel() if buf is not None else 0
        buf = torch.zeros(max(need, grown), dtype=torch.uint8,
                          device=torch.device("cuda", index))
        _adasum_scratch[key] = buf
    return buf.data_ptr(), buf.numel()


def adasum_combine_pairs(a, b):
    """[m, n] x 2 f32/bf16/f16 -> [m, n] in the input dtype: pair ``i``
    combines ``a[i]`` with ``b[i]``. Replaces
    ``pallas_kernels.adasum_combine_pairs``; unlike it, any ``n`` is taken
    (no lane alignment, so nothing is padded). Rows may be strided views
    (``buf[0::2]``, ``buf[1::2]`` of a tree level): only the elements of a
    row must be contiguous. One launch a call: a one-entry table of
    :func:`adasum_combine_pairs_many`'s kernel."""
    dev = a.device if isinstance(a, torch.Tensor) else None
    if not _adasum_pair_ok(a, b, dev):
        _reject_pair("adasum_combine_pairs", a, b, dev)
    m, n = a.shape
    if dev.type == "cpu":
        return adasum_combine_pairs_plain(a, b)
    if dev.type != "cuda":
        raise ValueError(f"adasum_combine_pairs: unsupported device {dev}")
    out = torch.empty((m, n), dtype=a.dtype, device=dev)
    if m and n:
        slots, size = _adasum_slots(dev.index, m)
        _launch("hvd_adasum_combine", dev.index, a.data_ptr(), a.stride(0),
                b.data_ptr(), b.stride(0), _FLOATS[a.dtype], out.data_ptr(),
                m, n, slots, size)
        adasum_combine_pairs.launches += 1
    return out


def adasum_tables(pairs, outs, per_table: int) -> list:
    """The launch tables of :func:`adasum_combine_pairs_many`: per dtype,
    in the order first met, a row ``(a, lda, b, ldb, out, m, n)`` (pointers
    and strides as ints) for each non-empty pair set, cut into tables of at
    most ``per_table`` rows. Returns ``[(dtype, table, pairs)]``, ``table``
    an ``array('q')`` and ``pairs`` the sum of its ``m``."""
    groups = {}
    for (a, b), out in zip(pairs, outs):
        m, n = a.shape
        if m and n:
            groups.setdefault(a.dtype, array.array("q")).extend(
                (a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0),
                 out.data_ptr(), m, n))
    tables = []
    for dtype, rows in groups.items():
        for k in range(0, len(rows), 7 * per_table):
            table = rows[k:k + 7 * per_table]
            tables.append((dtype, table, sum(table[5::7])))
    return tables


def _adasum_outputs(pairs, dev) -> list:
    """Contiguous [m, n] outputs, one flat buffer a dtype; each starts on a
    16-byte boundary (the kernel's vector stores)."""
    places, sizes = [], {}
    for a, _ in pairs:
        at = sizes.get(a.dtype, 0)
        places.append(at)
        step = 16 // a.element_size()
        sizes[a.dtype] = at + -(-a.numel() // step) * step
    flats = {dt: torch.empty(max(size, 1), dtype=dt, device=dev)
             for dt, size in sizes.items()}
    return [flats[a.dtype].as_strided(tuple(a.shape), (a.shape[1], 1), at)
            for (a, _), at in zip(pairs, places)]


def adasum_combine_pairs_many(pairs):
    """Pair sets ``(a_i, b_i)``, each as :func:`adasum_combine_pairs`
    takes it (f32/bf16/f16, dtypes may differ between sets), all on one
    device -> their combines, ``[m_i, n_i]`` in each set's dtype, with the
    bits of :func:`adasum_combine_pairs` on each set (coefficients per
    pair). On the card one launch takes every set of a dtype, up to
    ``hvd_adasum_table_entries()`` sets (one launch per table of that
    many); each launch counts in ``adasum_combine_pairs.launches``."""
    pairs = list(pairs)
    dev = pairs[0][0].device if pairs and isinstance(
        pairs[0][0], torch.Tensor) else torch.device("cpu")
    for i, (a, b) in enumerate(pairs):
        if not _adasum_pair_ok(a, b, dev):
            _reject_pair(f"adasum_combine_pairs_many pair set {i}", a, b, dev)
    if dev.type == "cpu":
        return adasum_combine_pairs_many_plain(pairs)
    if dev.type != "cuda":
        raise ValueError(f"adasum_combine_pairs_many: unsupported device "
                         f"{dev}")
    outs = _adasum_outputs(pairs, dev)
    tables = adasum_tables(pairs, outs, _adasum_limits()[0])
    for dtype, table, npairs in tables:
        slots, size = _adasum_slots(dev.index, npairs)
        _launch("hvd_adasum_combine_many", dev.index, table.buffer_info()[0],
                len(table) // 7, _FLOATS[dtype], slots, size)
        adasum_combine_pairs.launches += 1
    return outs


# ------------------------------------------------------ flash attention
# Operands are [B, T, H, D] in the reference's layout; the statistics lse
# and D = rowsum(dO * O) are [B, H, Tq] f32.
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453
_ATTN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ATTN_HEAD_DIMS = (32, 64, 128)  # the kernel's instantiations


def _scores(q, k, scale, causal, q_off, k_off):
    """[B, H, Tq, Tk] f32 logits ``scale * q.k``, -inf where the causal mask
    hides a key (global positions ``q_off + i`` against ``k_off + j``)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        qpos = q_off + torch.arange(q.shape[1], device=q.device)
        kpos = k_off + torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(qpos[:, None] < kpos[None, :], float("-inf"))
    return s


def flash_attention_fwd_plain(q, k, v, *, causal, scale, q_off=0, k_off=0):
    """Plain attention with the flash kernel's contract: (out [B, Tq, H, D]
    in q's dtype, lse [B, H, Tq] f32, natural log). A fully masked row gives
    out 0 and lse 0 (``pallas_kernels._masked_row_stats``)."""
    s = _scores(q, k, scale, causal, q_off, k_off)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - torch.where(m == float("-inf"), torch.zeros_like(m), m))
    l_safe, lse = _masked_row_stats(m, e.sum(-1, keepdim=True))
    out = torch.einsum("bhqk,bkhd->bqhd", e / l_safe, v.float()).to(q.dtype)
    return out, lse[..., 0]


def flash_attention_bwd_plain(q, k, v, dout, lse, dd, *, causal, scale,
                              out_dtype=None, q_off=0, k_off=0):
    """(dq, dk, dv) from the saved lse, with the kernel's contract: p =
    exp(s - lse) recomputed (no autograd through the scores), dS = p (dP -
    D) scale, p and dS rounded to q's dtype before their products, f32
    sums; outputs in ``out_dtype`` (default q's dtype)."""
    def operand(x):
        return x.to(q.dtype).float()

    s = _scores(q, k, scale, causal, q_off, k_off)
    p = torch.exp(s - lse[..., None])
    dof = dout.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", operand(p), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    ds = operand(p * (dp - dd[..., None]) * scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    out = out_dtype or q.dtype
    return dq.to(out), dk.to(out), dv.to(out)


def _check_bthd(t, what: str) -> None:
    if not isinstance(t, torch.Tensor) or t.dim() != 4:
        raise ValueError(f"{what}: expected a [B, T, H, D] tensor, got "
                         f"{getattr(t, 'shape', type(t))}")
    if t.dtype not in _ATTN_DTYPES:
        raise TypeError(f"{what}: dtype {t.dtype} not in float32, bfloat16")
    if t.shape[3] > 1 and t.stride(3) != 1:
        raise ValueError(f"{what}: the D values of a row must be contiguous "
                         f"(strides {t.stride()})")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")


def _check_attention(q, k, v, dout=None) -> None:
    # the common case in few attribute reads (a launch's host time is part
    # of its cost); anything else is named by the checks below
    try:
        dt, dev = q.dtype, q.get_device()  # -1 off the card
        b, _, h, d = q.shape
        kb, _, kh, kd = k.shape
        ok = (dt in _ATTN_DTYPES and k.shape == v.shape and kb == b
              and kh == h and kd == d
              and (dout is None or dout.shape == q.shape)
              and (q.is_cuda and d in _ATTN_HEAD_DIMS
                   or dev < 0 and q.device.type == "cpu"))
        for t in (q, k, v) if dout is None else (q, k, v, dout):
            ok = (ok and t.dtype == dt and t.get_device() == dev
                  and (d == 1 or t.stride(3) == 1))
        if ok:
            return
    except (AttributeError, TypeError, ValueError):
        pass
    named = [("q", q), ("k", k), ("v", v)] + (
        [] if dout is None else [("dout", dout)])
    for what, t in named:
        _check_bthd(t, what)
    b, _, h, d = q.shape
    if (k.shape != v.shape or (b, h, d) != (k.shape[0], k.shape[2],
                                            k.shape[3])
            or (dout is not None and dout.shape != q.shape)
            or any(t.dtype != q.dtype or t.device != q.device
                   for _, t in named)):
        raise ValueError("flash attention: q, k, v (and dout) must agree in "
                         "batch, heads, head dim, dtype and device; got "
                         + ", ".join(f"{n} {tuple(t.shape)} {t.dtype} "
                                     f"{t.device}" for n, t in named))
    if q.device.type == "cuda" and d not in _ATTN_HEAD_DIMS:
        raise ValueError(f"flash attention: head dim {d} not in "
                         f"{_ATTN_HEAD_DIMS} (the kernel's instantiations)")


def _aligned_rows(t):
    """``t`` if every row starts on a 16-byte boundary, else a contiguous
    copy (the kernel reads rows 16 bytes at a time)."""
    sb, st, sh = t.stride()[:3]
    if (t.data_ptr() | (sb | st | sh) * t.element_size()) % 16 == 0:
        return t  # 16 / element size is a power of 2: OR-ing is exact
    return t.clone(memory_format=torch.contiguous_format)


def _hopper_route(dtype, d: int, out_dtype=None) -> bool:
    """Whether a card call with operands of ``dtype``, head dim ``d`` and
    (for the backward) gradients in ``out_dtype`` takes the wgmma / TMA
    kernels of ``csrc/flash_attention_sm90.cu``: bf16 at D = 64 does, for
    the forward, the ring step and the backward with bf16 or f32 gradients;
    the rest takes ``csrc/flash_attention.cu``."""
    return (dtype == torch.bfloat16 and d == 64
            and out_dtype in (None, torch.bfloat16, torch.float32))


def _operand_args(*ts):
    """(pointer, sb, st, sh) of each operand, flat, as the sm90 launchers
    take them."""
    return [x for t in ts for x in (t.data_ptr(), *t.stride()[:3])]


def _operand_table(*ts):
    """Host arrays of the operands' pointers and (sb, st, sh) strides."""
    ptrs = (ctypes.c_int64 * len(ts))(*[t.data_ptr() for t in ts])
    strides = (ctypes.c_int64 * (3 * len(ts)))(
        *[s for t in ts for s in t.stride()[:3]])
    return ptrs, strides


def flash_attention_fwd(q, k, v, *, causal=False, scale=None, q_off=0,
                        k_off=0):
    """q [B, Tq, H, D], k and v [B, Tk, H, D], f32 or bf16 -> (out [B, Tq,
    H, D] in q's dtype, lse [B, H, Tq] f32). Replaces
    ``pallas_kernels._flash_fwd_once_call``; operands may be strided views
    (the q, k, v of a fused qkv projection are read in place). ``q_off`` /
    ``k_off``: global positions of row 0 for the causal mask. On the card
    D is 32, 64 or 128; any T."""
    _check_attention(q, k, v)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    scale = d ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal=causal, scale=scale,
                                         q_off=q_off, k_off=k_off)
    if not (b and h and tq and tk):  # no keys: every row 0, and lse 0
        return (torch.zeros((b, tq, h, d), dtype=q.dtype, device=q.device),
                torch.zeros((b, h, tq), dtype=torch.float32, device=q.device))
    # the kernels write every element, masked rows included
    out = q.new_empty((b, tq, h, d))
    lse = q.new_empty((b, h, tq), dtype=torch.float32)
    q, k, v = (_aligned_rows(t) for t in (q, k, v))
    if _hopper_route(q.dtype, d):
        _launch("hvd_flash_fwd_sm90", q.get_device(),
                *_operand_args(q, k, v), b, h, tq, tk, q_off, k_off,
                int(causal), scale * _LOG2E, out.data_ptr(), lse.data_ptr())
    else:
        ptrs, strides = _operand_table(q, k, v)
        _launch("hvd_flash_fwd", q.get_device(), ctypes.addressof(ptrs),
                ctypes.addressof(strides), _ATTN_DTYPES[q.dtype], b, h, tq,
                tk, d, q_off, k_off, int(causal), scale * _LOG2E,
                out.data_ptr(), lse.data_ptr())
    flash_attention_fwd.launches += 1
    return out, lse


def attention_delta(dout, out):
    """D = rowsum(dO * O) [B, H, T] f32 from dO and O [B, T, H, D]: the
    backward's per-row statistic."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd(q, k, v, dout, lse, dd=None, *, out=None,
                        causal=False, scale=None, out_dtype=None, q_off=0,
                        k_off=0):
    """(dq, dk, dv) of flash attention from q, k, v, dO [B, T, H, D] and
    lse, D = rowsum(dO * O) [B, H, Tq] f32, in ``out_dtype``: q's dtype
    (the default; the single-device path) or f32 (the reference's
    two-pass and ring contract). With ``dd=None``, D comes from ``out``,
    the forward's output [B, Tq, H, D]: on the wgmma route the dq kernel
    makes it, elsewhere :func:`attention_delta`. Replaces
    ``pallas_kernels._flash_bwd_fused``, ``_flash_bwd_resident`` and the
    streaming branch of ``_flash_bwd_hm`` (``:1084``, the ring backward past
    the fused kernel's dq cap): with f32 outputs at a hop's ``q_off`` /
    ``k_off`` it is the ring backward's hop, exact zeros where ``k_off``
    lies past the last q row. One call, two CUDA kernels (dq; dk and dv),
    deterministic."""
    _check_attention(q, k, v, dout)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if dd is None:
        if out is None:
            raise ValueError("flash_attention_bwd: give dd, or out to make "
                             "it from")
        _check_attention(q, k, v, out)
    for what, t in (("lse", lse), ("dd", dd))[:1 if dd is None else 2]:
        if (not isinstance(t, torch.Tensor) or t.dtype != torch.float32
                or tuple(t.shape) != (b, h, tq) or t.device != q.device):
            raise ValueError(f"flash_attention_bwd: {what} must be f32 "
                             f"[{b}, {h}, {tq}] on {q.device}")
    out_dtype = q.dtype if out_dtype is None else out_dtype
    if out_dtype not in (q.dtype, torch.float32):
        raise TypeError(f"flash_attention_bwd: out_dtype {out_dtype} is "
                        f"neither {q.dtype} nor float32")
    scale = d ** -0.5 if scale is None else float(scale)
    hopper = (q.device.type == "cuda"
              and _hopper_route(q.dtype, d, out_dtype))
    if dd is None and not hopper:
        dd = attention_delta(dout, out)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, dout, lse, dd,
                                         causal=causal, scale=scale,
                                         out_dtype=out_dtype, q_off=q_off,
                                         k_off=k_off)
    if not (b and h and tq and tk):
        return tuple(q.new_zeros((b, t, h, d), dtype=out_dtype)
                     for t in (tq, tk, tk))
    # the kernels write every element, rows no query sees included
    dq = q.new_empty((b, tq, h, d), dtype=out_dtype)
    dk = q.new_empty((b, tk, h, d), dtype=out_dtype)
    dv = q.new_empty((b, tk, h, d), dtype=out_dtype)
    q, k, v, dout = (_aligned_rows(t) for t in (q, k, v, dout))
    if hopper:
        # TMA reads the statistics' rows at 16-byte strides: rows of ld
        ld = -(-tq // 4) * 4

        def rows_of_ld(t):
            return (torch.nn.functional.pad(t, (0, ld - tq)) if ld != tq
                    else t.contiguous())

        lse = rows_of_ld(lse)
        make_d = dd is None
        if make_d:  # the dq kernel writes D here for the dk+dv kernel
            dd = q.new_empty((b, h, ld), dtype=torch.float32)
            out = _aligned_rows(out)
        else:
            dd = rows_of_ld(dd)
        _launch("hvd_flash_bwd_sm90", q.get_device(),
                *_operand_args(q, k, v, dout, out if make_d else q), b, h,
                tq, tk, q_off, k_off, int(causal), scale, scale * _LOG2E,
                lse.data_ptr(), dd.data_ptr(), ld, int(make_d),
                int(out_dtype == torch.float32), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr())
    else:
        lse, dd = lse.contiguous(), dd.contiguous()
        ptrs, strides = _operand_table(q, k, v, dout)
        _launch("hvd_flash_bwd", q.get_device(), ctypes.addressof(ptrs),
                ctypes.addressof(strides), _ATTN_DTYPES[q.dtype],
                int(out_dtype == torch.float32), b, h, tq, tk, d, q_off,
                k_off, int(causal), scale, scale * _LOG2E, lse.data_ptr(),
                dd.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    flash_attention_bwd.launches += 1
    return dq, dk, dv


# ------------------------------------------- the ring hop of flash attention
def flash_attention_step_plain(q, k, v, m, l, o, *, causal, scale, q_off=0,
                               k_off=0):
    """One hop of flash accumulation with the kernel's contract, as new
    tensors: q [B, Tq, H, D], k and v [B, Tk, H, D]; m and l [B, H, Tq] f32,
    m in natural log units; o [B, Tq, H, D] f32, unnormalized. The
    softmax runs in base 2 (m enters as m log2 e and leaves as m ln 2,
    except that a row whose maximum the hop does not raise keeps its m bit
    for bit); p rounds to q's dtype before it multiplies v. A hop that
    shows q no key returns the carry itself."""
    if k.shape[1] == 0 or (causal and k_off > q_off + q.shape[1] - 1):
        return m, l, o  # no key of the hop is visible
    s = _scores(q, k, scale * _LOG2E, causal, q_off, k_off)
    m2 = m * _LOG2E
    m_new = torch.maximum(m2, s.amax(-1))
    m_safe = torch.where(m_new == float("-inf"), torch.zeros_like(m_new),
                         m_new)
    p = torch.exp2(s - m_safe[..., None])
    alpha = torch.exp2(m2 - m_safe)
    l_new = l * alpha + p.sum(-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).float(), v.float())
    o_new = o * alpha.transpose(1, 2)[..., None] + pv
    m_out = torch.where(m_new == m2, m, m_new * _LN2)
    return m_out, l_new, o_new


def _check_carry(b, tq, h, d, m, l, o, device) -> None:
    for what, t, shape in (("m", m, (b, h, tq)), ("l", l, (b, h, tq)),
                           ("o", o, (b, tq, h, d))):
        if (not isinstance(t, torch.Tensor) or t.dtype != torch.float32
                or tuple(t.shape) != shape or t.device != device
                or not t.is_contiguous()):
            raise ValueError(f"flash_attention_step: {what} must be a "
                             f"contiguous f32 {list(shape)} tensor on "
                             f"{device}, got {getattr(t, 'shape', type(t))}")


def flash_attention_step(q, k, v, m, l, o, *, causal=False, scale=None,
                         q_off=0, k_off=0):
    """One hop of ring attention, in place: accumulates q [B, Tq, H, D]
    against this hop's k and v [B, Tk, H, D] (f32 or bf16, strided views
    allowed) into the carry m, l [B, H, Tq] and o [B, Tq, H, D] (contiguous
    f32; see :func:`flash_attention_step_plain` for the contract), and
    returns ``(m, l, o)``. ``q_off`` / ``k_off``: the hop's global positions
    of q row 0 and k row 0. A hop that shows q no key leaves the carry bit
    for bit. Replaces ``pallas_kernels._flash_step_call`` (resident k/v)
    and ``_flash_step_call_streaming`` (streamed k/v): kernel K6 streams
    its k/v tiles at any length. On the card D is 32, 64 or 128; bf16 at
    D = 64 runs the wgmma / TMA kernel."""
    _check_attention(q, k, v)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    _check_carry(b, tq, h, d, m, l, o, q.device)
    scale = d ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        for t, new in zip((m, l, o), flash_attention_step_plain(
                q, k, v, m, l, o, causal=causal, scale=scale, q_off=q_off,
                k_off=k_off)):
            if new is not t:
                t.copy_(new)
        return m, l, o
    if b and h and tq and tk:
        q, k, v = (_aligned_rows(t) for t in (q, k, v))
        if _hopper_route(q.dtype, d):
            _launch("hvd_flash_step_sm90", q.get_device(),
                    *_operand_args(q, k, v), b, h, tq, tk, q_off, k_off,
                    int(causal), scale * _LOG2E, m.data_ptr(), l.data_ptr(),
                    o.data_ptr())
        else:
            ptrs, strides = _operand_table(q, k, v)
            _launch("hvd_flash_step", q.get_device(), ctypes.addressof(ptrs),
                    ctypes.addressof(strides), _ATTN_DTYPES[q.dtype], b, h,
                    tq, tk, d, q_off, k_off, int(causal), scale * _LOG2E,
                    m.data_ptr(), l.data_ptr(), o.data_ptr())
        flash_attention_step.launches += 1
    return m, l, o


def _masked_row_stats(m, l):
    """(l_safe, lse) from raw flash statistics of any matching shapes: the
    fully-masked-row convention (l == 0 divides by 1, so out is 0; m ==
    -inf gives the LSE sentinel 0), on which the backward's recompute of
    p = exp(s - lse) relies."""
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    lse = torch.where(m == float("-inf"), torch.zeros_like(m), m) + \
        torch.log(l_safe)
    return l_safe, lse


def finalize_attention_stats(m, l, o, out_dtype):
    """(m, l, o) of the ring (m, l [B, H, T]; o [B, T, H, D]) -> (out
    [B, T, H, D] in ``out_dtype``, lse [B, H, T] f32)."""
    l_safe, lse = _masked_row_stats(m, l)
    out = (o / l_safe.transpose(1, 2)[..., None]).to(out_dtype)
    return out, lse


# --------------------------------------------------------------- layernorm
def layer_norm_fwd_plain(x2, gamma, beta, eps):
    """[N, D] -> (y [N, D] in x's dtype, mean [N] f32, rstd [N] f32): the
    two-pass f32 statistics of ``pallas_kernels._ln_fwd_kernel``."""
    xf = x2.float()
    d = x2.shape[1]
    mean = xf.sum(1, keepdim=True) / d
    xc = xf - mean
    var = (xc * xc).sum(1, keepdim=True) / d
    rstd = torch.rsqrt(var + eps)
    y = xc * rstd * gamma.float() + beta.float()
    return y.to(x2.dtype), mean[:, 0], rstd[:, 0]


def layer_norm_fwd(x2, gamma, beta, eps: float = 1e-6):
    """Contiguous [N, D] f32/bf16/f16, gamma and beta [D] -> (y [N, D] in
    x's dtype, mean [N] f32, rstd [N] f32). Replaces
    ``pallas_kernels._ln_fused_fwd_call``; any D (no lane gate). gamma and
    beta are used in f32."""
    y, stats = layer_norm_rows(x2, gamma, beta, eps)
    return y, stats[0], stats[1]


def layer_norm_rows(x2, gamma, beta, eps: float = 1e-6):
    """:func:`layer_norm_fwd` with mean and rstd as the two rows of one
    [2, N] f32 tensor (one allocation; the autograd function saves it
    whole)."""
    _check_2d(x2, "layer_norm_fwd", _FLOATS)
    n, d = x2.shape
    for what, t in (("gamma", gamma), ("beta", beta)):
        if (not isinstance(t, torch.Tensor) or t.shape != (d,)
                or t.device != x2.device or not t.is_floating_point()):
            raise ValueError(f"layer_norm_fwd: {what} must be a float [{d}] "
                             f"tensor on {x2.device}")
    if x2.device.type == "cpu":
        y, mean, rstd = layer_norm_fwd_plain(x2, gamma, beta, eps)
        return y, torch.stack((mean, rstd))
    y = torch.empty_like(x2)
    stats = x2.new_empty((2, n), dtype=torch.float32)
    if n and d:
        g, bt = gamma.float().contiguous(), beta.float().contiguous()
        at = stats.data_ptr()
        _launch("hvd_layer_norm_fwd", x2.get_device(), x2.data_ptr(),
                _FLOATS[x2.dtype], g.data_ptr(), bt.data_ptr(), y.data_ptr(),
                at, at + 4 * n, n, d, float(eps))
        layer_norm_fwd.launches += 1
    return y, stats


# ------------------------------------------------------------------- adamw
_ADAMW_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def adamw_update_plain(p, g, mu, nu, *, lr, ibc1, ibc2, b1, b2, eps, wd):
    """One leaf's AdamW step in place, in the order of
    ``optim/fused.py:_adamw_kernel``: every operation in f32; p' in p's
    dtype, mu' in mu's, nu' f32."""
    gf = g.float()
    pf = p.float()
    m = b1 * mu.float() + (1.0 - b1) * gf
    v = b2 * nu + (1.0 - b2) * gf * gf
    upd = (m * ibc1) / (torch.sqrt(v * ibc2) + eps) + wd * pf
    p.copy_(pf - lr * upd)
    mu.copy_(m)
    nu.copy_(v)


def adamw_update(params, grads, mus, nus, *, lr=None, ibc1=None, ibc2=None,
                 b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                 scalars=None) -> None:
    """AdamW step of every leaf, in place: p, mu and nu are overwritten.
    ``lr``, ``ibc1`` = 1/(1-b1^t), ``ibc2`` = 1/(1-b2^t) are the step's
    scalars, given as floats or as ``scalars``, an f32 ``[3]`` tensor
    ``[lr, ibc1, ibc2]`` on the leaves' device that the kernel reads when it
    runs (so a CUDA graph that captured the launch takes the values written
    there before each replay). p and g f32 or bf16 (the same), mu f32 or
    bf16, nu f32, all contiguous. Replaces
    ``optim/fused.py:_apply_leaf_fused``: on the card one launch covers up
    to ``hvd_adamw_table_leaves()`` leaves of a (device, p dtype, mu dtype)
    group, whatever their lengths; the table rides in the launch's
    parameters (nothing is copied to the device)."""
    if not len(params) == len(grads) == len(mus) == len(nus):
        raise ValueError("adamw_update: params, grads, mus and nus differ "
                         "in length")
    if scalars is not None:
        if (not isinstance(scalars, torch.Tensor)
                or scalars.dtype != torch.float32
                or tuple(scalars.shape) != (3,)
                or not scalars.is_contiguous()):
            raise ValueError("adamw_update: scalars must be a contiguous "
                             "float32 [3] tensor [lr, ibc1, ibc2]")
    elif None in (lr, ibc1, ibc2):
        raise ValueError("adamw_update: give lr, ibc1 and ibc2, or scalars")
    groups = {}
    for i, (p, g, mu, nu) in enumerate(zip(params, grads, mus, nus)):
        if (p.shape != g.shape or p.shape != mu.shape or p.shape != nu.shape
                or p.dtype not in _ADAMW_DTYPES or g.dtype != p.dtype
                or mu.dtype not in _ADAMW_DTYPES or nu.dtype != torch.float32
                or len({t.device for t in (p, g, mu, nu)}) != 1
                or not all(t.is_contiguous() for t in (p, g, mu, nu))):
            raise ValueError(
                f"adamw_update: leaf {i}: p {tuple(p.shape)} {p.dtype}, g "
                f"{tuple(g.shape)} {g.dtype}, mu {tuple(mu.shape)} "
                f"{mu.dtype}, nu {tuple(nu.shape)} {nu.dtype} (want one "
                "shape, contiguous, on one device; p and g f32 or bf16 "
                "alike, mu f32 or bf16, nu f32)")
        if scalars is not None and scalars.device != p.device:
            raise ValueError(f"adamw_update: scalars on {scalars.device}, "
                             f"leaf {i} on {p.device}")
        if p.device.type == "cpu":
            if scalars is not None:
                lr, ibc1, ibc2 = scalars.tolist()
            adamw_update_plain(p, g, mu, nu, lr=lr, ibc1=ibc1, ibc2=ibc2,
                               b1=b1, b2=b2, eps=eps, wd=weight_decay)
        elif p.numel():
            groups.setdefault((p.device, p.dtype, mu.dtype), []).append(
                (p, g, mu, nu))
    if not groups:
        return
    per_table = 5 * _kernel("hvd_adamw_table_leaves")[1]()
    dev_scalars = 0 if scalars is None else scalars.data_ptr()
    host = (0.0, 0.0, 0.0) if scalars is not None else (lr, ibc1, ibc2)
    for (dev, p_dtype, mu_dtype), leaves in groups.items():
        rows = array.array("q")
        for p, g, mu, nu in leaves:
            rows.extend((g.data_ptr(), p.data_ptr(), mu.data_ptr(),
                         nu.data_ptr(), p.numel()))
        for k in range(0, len(rows), per_table):
            part = rows[k:k + per_table]
            _launch("hvd_adamw", dev.index, part.buffer_info()[0],
                    len(part) // 5, _ADAMW_DTYPES[p_dtype],
                    _ADAMW_DTYPES[mu_dtype], dev_scalars, *host, b1,
                    1.0 - b1, b2, 1.0 - b2, eps, weight_decay)
            adamw_update.launches += 1


# ------------------------------------------------------------------ matmul
_LANES = 128
_MM_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _pick_block(t: int, preferred: int):
    """Largest power-of-2 tile <= ``preferred`` dividing ``t``, or None if
    none >= 8 does (``pallas_kernels._pick_block`` with its edge given)."""
    b = preferred
    while b >= 8:
        if t % b == 0:
            return b
        b //= 2
    return None


def matmul_tiles(mdim: int, kdim: int, ndim: int):
    """(bm, bk, bn) of ``pallas_kernels.matmul_tiles`` for an [M, K] @ [K,
    N] product, or None when the shape does not tile (K or N not a multiple
    of 128, or no power-of-2 row tile >= 8 divides M). The port's kernel
    tiles otherwise; the rule only decides which shapes run it."""
    if kdim % _LANES or ndim % _LANES:
        return None
    bm = _pick_block(mdim, 256)
    bk = _pick_block(kdim, 512)
    bn = _pick_block(ndim, 256)
    if bm is None or bk is None or bn is None:
        return None
    return bm, bk, bn


def matmul_2d_plain(x2, w2):
    """[M, K] @ [K, N] with f32 sums, in the inputs' dtype."""
    return torch.matmul(x2.float(), w2.float()).to(x2.dtype)


def matmul_2d(x2, w2):
    """x2 [M, K] @ w2 [K, N], f32 or bf16 (one dtype), contiguous ->
    [M, N] in that dtype, the sum accumulated in f32 (bf16: wgmma with TMA
    loads and stores, a persistent kernel; f32: full f32 FMA, no TF32).
    Replaces ``pallas_kernels.matmul_2d``; raises ``ValueError`` on mixed
    dtypes or a shape ``matmul_tiles`` refuses. Forward only, as the TPU
    kernel (no VJP)."""
    _check_2d(x2, "matmul_2d x", _MM_DTYPES)
    _check_2d(w2, "matmul_2d w", _MM_DTYPES)
    if x2.dtype != w2.dtype or x2.device != w2.device:
        raise ValueError(f"matmul_2d: x {x2.dtype} on {x2.device} and w "
                         f"{w2.dtype} on {w2.device} must share dtype and "
                         "device")
    (mdim, kdim), ndim = x2.shape, w2.shape[1]
    if w2.shape[0] != kdim or matmul_tiles(mdim, kdim, ndim) is None:
        raise ValueError(f"matmul_2d: [{mdim}, {kdim}] @ {list(w2.shape)} "
                         "does not tile (K and N multiples of 128, M of 8)")
    if x2.device.type == "cpu":
        return matmul_2d_plain(x2, w2)
    if not (mdim and kdim and ndim):  # an empty sum is 0
        return torch.zeros((mdim, ndim), dtype=x2.dtype, device=x2.device)
    if x2.data_ptr() % 16 or w2.data_ptr() % 16:
        raise ValueError("matmul_2d: operands must start on a 16-byte "
                         "boundary")
    out = torch.empty((mdim, ndim), dtype=x2.dtype, device=x2.device)
    _launch("hvd_matmul", x2.get_device(), x2.data_ptr(), w2.data_ptr(),
            _MM_DTYPES[x2.dtype], mdim, kdim, ndim, out.data_ptr())
    matmul_2d.launches += 1
    return out


WRAPPERS = (int8_quantize_2d, int8_dequantize_2d, int8_quantize_pack_2d,
            int4_quantize_pack_2d, adasum_combine_pairs, flash_attention_fwd,
            flash_attention_bwd, layer_norm_fwd, adamw_update,
            flash_attention_step, matmul_2d)
for _w in WRAPPERS:
    _w.launches = 0


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {w.__name__: w.launches for w in WRAPPERS}


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0


def add_launches(counts: dict) -> None:
    """Add ``counts`` (wrapper name -> launches) to the counters: what a
    CUDA graph's replay launched, from the counts its capture took."""
    for w in WRAPPERS:
        w.launches += counts.get(w.__name__, 0)


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
