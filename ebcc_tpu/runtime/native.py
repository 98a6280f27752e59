"""ctypes loader for the native host runtime (libebcc_host.so).

The reference's runtime is native C (SURVEY.md §2.1); this framework's
device path is JAX/XLA, and this module is its native *host* runtime: the
bitplane coder, a batched zstd entropy stage, the u16 quantiser and the
standalone CPU encoder/decoder, built from ``native/*.cc``.  The device
path needs it: :func:`require` raises when it cannot be loaded.

The library is compiled with ``-march=native`` for the machine that builds
it, so it is rebuilt from the committed sources (``make -C native clean
all``) whenever it is missing, older than a source file, or was built on
another host (:func:`is_stale`).  ``HAVE_NATIVE`` says whether it loaded;
``BUILD_ERROR`` holds the compiler's output when the build failed.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import platform
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_HERE, "native")
_USER_LIB = os.environ.get("EBCC_HOST_LIB")
_LIB_PATH = _USER_LIB or os.path.join(_NATIVE_DIR, "libebcc_host.so")
# host fingerprint of the last successful in-tree build
_STAMP_PATH = os.path.join(_NATIVE_DIR, "libebcc_host.stamp")

_lib = None
BUILD_ERROR: str | None = None
LAST_BUILD_S: float | None = None  # seconds of this process's last build


def host_id() -> str:
    """Fingerprint of this build host: node name plus the CPU model and
    feature flags that ``-march=native`` compiles for."""
    cpu = ""
    try:
        with open("/proc/cpuinfo") as f:
            keep = [ln for ln in f if ln.startswith(("model name", "flags"))]
        cpu = "".join(sorted(set(keep)))
    except OSError:
        pass
    raw = "\n".join((platform.node(), platform.machine(), cpu))
    return hashlib.sha256(raw.encode()).hexdigest()[:16]


def _sources() -> list[str]:
    return (glob.glob(os.path.join(_NATIVE_DIR, "*.cc")) +
            [os.path.join(_NATIVE_DIR, "Makefile")])


def is_stale() -> bool:
    """Whether the in-tree library must be rebuilt: missing, older than a
    committed source, or built on another host."""
    try:
        built = os.path.getmtime(_LIB_PATH)
        with open(_STAMP_PATH) as f:
            stamp = f.read().strip()
    except OSError:
        return True
    if any(os.path.getmtime(src) > built for src in _sources()):
        return True
    return stamp != host_id()


def build(quiet: bool = True) -> bool:
    """``make -C native clean all`` from the committed sources, then stamp
    the library with this host's fingerprint.  Returns success; the
    compiler output of a failed build is kept in ``BUILD_ERROR``."""
    global BUILD_ERROR, LAST_BUILD_S
    import fcntl
    import time

    # one build at a time across processes (parallel test workers)
    with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not is_stale():
            return True
        t0 = time.perf_counter()
        # clean first, in its own make run: a parallel "clean all" races
        subprocess.run(["make", "-C", _NATIVE_DIR, "clean"],
                       capture_output=True)
        r = subprocess.run(["make", "-C", _NATIVE_DIR,
                            "-j", str(os.cpu_count() or 1), "all"],
                           capture_output=True, text=True)
        LAST_BUILD_S = time.perf_counter() - t0
        if not quiet:
            print(r.stdout + r.stderr, end="")
        if r.returncode != 0 or not os.path.exists(_LIB_PATH):
            BUILD_ERROR = (r.stdout + r.stderr)[-4000:]
            return False
        with open(_STAMP_PATH, "w") as f:
            f.write(host_id())
        BUILD_ERROR = None
        return True


def _load():
    global _lib, BUILD_ERROR
    if _lib is not None:
        return _lib
    if not _USER_LIB and is_stale() and not build():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as e:
        BUILD_ERROR = str(e)
        return None
    lib.ebcc_zstd_bound.restype = ctypes.c_size_t
    lib.ebcc_zstd_bound.argtypes = [ctypes.c_size_t]
    lib.ebcc_host_version.restype = ctypes.c_int
    lib.ebcc_coder_fast_path.restype = ctypes.c_int
    lib.ebcc_coder_fast_path.argtypes = []
    _lib = lib
    return lib


HAVE_NATIVE = _load() is not None


def require() -> None:
    """Raise unless the native runtime is loaded: the device path's host
    coder, zstd stage and u16 quantiser live there, and there is no
    substitute for them."""
    if _load() is None:
        raise RuntimeError(
            "native host runtime unavailable (make -C native failed):\n"
            + (BUILD_ERROR or ""))


def coder_path() -> str:
    """Which bitplane coder the library dispatches to: "bmi2" (the
    word-parallel path) or "scalar"."""
    require()
    return "bmi2" if _lib.ebcc_coder_fast_path() else "scalar"


def force_coder_path(mode: int):
    """Test hook: 0 = auto, 1 = force scalar coder, 2 = force word-parallel
    (BMI2) coder."""
    lib = _load()
    if lib is not None:
        lib.ebcc_coder_force_path(ctypes.c_int(mode))


def _ptr_array(bufs):
    arr = (ctypes.POINTER(ctypes.c_uint8) * len(bufs))()
    for i, b in enumerate(bufs):
        arr[i] = ctypes.cast(
            ctypes.c_char_p(b), ctypes.POINTER(ctypes.c_uint8))
    return arr


def zstd_compress_batch(bufs: list[bytes], level: int) -> list[bytes]:
    """Compress a list of byte strings in parallel native threads."""
    lib = _load()
    n = len(bufs)
    if lib is None or n == 0:
        raise RuntimeError("native runtime unavailable")
    max_src = max(len(b) for b in bufs)
    cap = int(lib.ebcc_zstd_bound(max_src))
    dst = np.empty(n * cap, np.uint8)
    sizes_in = np.asarray([len(b) for b in bufs], np.uintp)
    sizes_out = np.zeros(n, np.uintp)
    lib.ebcc_zstd_compress_batch(
        _ptr_array(bufs),
        sizes_in.ctypes.data_as(ctypes.POINTER(ctypes.c_size_t)),
        ctypes.c_int(n), ctypes.c_int(level),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_size_t(cap),
        sizes_out.ctypes.data_as(ctypes.POINTER(ctypes.c_size_t)))
    out = []
    err = int(np.iinfo(np.uintp).max)
    for i in range(n):
        sz = int(sizes_out[i])
        if sz == err:
            raise RuntimeError("native zstd compression failed")
        out.append(dst[i * cap: i * cap + sz].tobytes())
    return out


def zstd_decompress_batch(bufs: list[bytes], max_sizes: list[int]
                          ) -> list[bytes]:
    lib = _load()
    n = len(bufs)
    if lib is None or n == 0:
        raise RuntimeError("native runtime unavailable")
    cap = max(1, max(int(m) for m in max_sizes))
    dst = np.empty(n * cap, np.uint8)
    sizes_in = np.asarray([len(b) for b in bufs], np.uintp)
    sizes_out = np.zeros(n, np.uintp)
    lib.ebcc_zstd_decompress_batch(
        _ptr_array(bufs),
        sizes_in.ctypes.data_as(ctypes.POINTER(ctypes.c_size_t)),
        ctypes.c_int(n),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_size_t(cap),
        sizes_out.ctypes.data_as(ctypes.POINTER(ctypes.c_size_t)))
    out = []
    err = int(np.iinfo(np.uintp).max)
    for i in range(n):
        sz = int(sizes_out[i])
        if sz == err:
            raise RuntimeError("native zstd decompression failed")
        out.append(dst[i * cap: i * cap + sz].tobytes())
    return out


def scale_u16_batch(frames: np.ndarray):
    """Host-side u16 quantisation for the device hostq encode
    (native/ebcc_cpu_encoder.cc ebcc_scale_u16_batch).

    Returns ``(u, mn, mx, maxq)``: the uint16 planes, per-frame ranges and
    per-frame quantisation-error bounds ``max |frames - dequantise(u)|``
    (padded by a few ulps for cross-backend fma drift).  The native CPU
    encoder computes maxq with the same code, which is what keeps device
    and CPU containers byte-identical under the tightened targets.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    frames = np.ascontiguousarray(frames, np.float32)
    n, h, w = frames.shape
    u = np.empty((n, h, w), np.uint16)
    mn = np.empty(n, np.float32)
    mx = np.empty(n, np.float32)
    maxq = np.empty(n, np.float32)
    lib.ebcc_scale_u16_batch(
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int(n), ctypes.c_int(h), ctypes.c_int(w),
        u.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        mn.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        mx.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        maxq.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return u, mn, mx, maxq


def words_to_bytes_batch(words: np.ndarray, nbits: np.ndarray) -> list[bytes]:
    """[n, nwords] u32 (native endian) + per-frame bit counts -> trimmed
    big-endian byte streams."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    words = np.ascontiguousarray(words, np.uint32)
    n, nwords = words.shape
    # clamp to the buffer: the C side computes byte counts from nbits and
    # would read/write past the per-frame slots otherwise
    nbits = np.minimum(np.ascontiguousarray(nbits, np.int32), nwords * 32)
    stride = nwords * 4
    dst = np.zeros(n * stride, np.uint8)
    lib.ebcc_words_to_bytes_batch(
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_int(n), ctypes.c_int(nwords),
        nbits.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_size_t(stride))
    return [dst[i * stride: i * stride + (int(nbits[i]) + 7) // 8].tobytes()
            for i in range(n)]


def coder_encode_batch(coef: np.ndarray, trunc_bits: np.ndarray,
                       group_levels: int, nplanes: int, nchunks: int,
                       shifts: np.ndarray | None = None) -> np.ndarray:
    """Native bitplane encode (native/ebcc_coder.cc).

    ``coef``: weighted coefficients [n, h, w] as int32, float32 (exact
    integers) or uint16 packed (sign bit 15, mag >> shifts[i] low);
    ``trunc_bits``: per-frame truncation.  Returns a uint8 arena
    [n, cap_bytes]; frame i's stream is ``arena[i, : (bits + 7) // 8]`` for
    any prefix ``bits <= trunc_bits[i]`` (embedded stream).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    coef = np.asarray(coef)
    n, h, w = coef.shape
    trunc = np.ascontiguousarray(trunc_bits, np.int64)
    cap_bytes = max(8, (int(trunc.max(initial=0)) + 7) // 8)
    out = np.zeros((n, cap_bytes), np.uint8)
    common = (ctypes.c_int(n), ctypes.c_int(h), ctypes.c_int(w),
              ctypes.c_int(group_levels), ctypes.c_int(nplanes),
              ctypes.c_int(nchunks),
              trunc.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
              out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
              ctypes.c_int64(cap_bytes))
    if coef.dtype == np.uint16:
        if shifts is None:
            raise ValueError("uint16 coefficients require shifts")
        coef = np.ascontiguousarray(coef)
        sh = np.ascontiguousarray(shifts, np.int32)
        lib.ebcc_coder_encode_batch_u16(
            coef.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            sh.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), *common)
    elif coef.dtype == np.uint8:
        if shifts is None:
            raise ValueError("uint8 coefficients require shifts")
        coef = np.ascontiguousarray(coef)
        sh = np.ascontiguousarray(shifts, np.int32)
        lib.ebcc_coder_encode_batch_u8(
            coef.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            sh.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), *common)
    elif coef.dtype == np.float32:
        coef = np.ascontiguousarray(coef)
        lib.ebcc_coder_encode_batch_f32(
            coef.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), *common)
    else:
        coef = np.ascontiguousarray(coef, np.int32)
        lib.ebcc_coder_encode_batch(
            coef.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), *common)
    return out


def _mask_ptrs(mask_plane, keep_mask, n):
    """ctypes (mask_plane*, keep_mask*) pair; NULLs when masking is off.
    Returns (ptr_mp, ptr_km, keepalive) — hold keepalive until the call."""
    if mask_plane is None:
        null32 = ctypes.POINTER(ctypes.c_int32)()
        nullu32 = ctypes.POINTER(ctypes.c_uint32)()
        return null32, nullu32, ()
    mp = np.ascontiguousarray(mask_plane, np.int32)
    km = np.ascontiguousarray(
        keep_mask if keep_mask is not None else np.zeros(n), np.uint32)
    return (mp.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            km.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), (mp, km))


def coder_decode_batch(streams: list[bytes], nbits: np.ndarray,
                       max_step: np.ndarray, h: int, w: int,
                       group_levels: int, nplanes: int, nchunks: int,
                       mask_plane: np.ndarray | None = None,
                       keep_mask: np.ndarray | None = None) -> np.ndarray:
    """Native structural decode -> float32 midpoint coefficients [n, h, w].

    ``mask_plane``/``keep_mask`` (format v4): per-frame chunk masks of the
    final coded plane; ``mask_plane[i] < 0`` disables for frame i."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    n = len(streams)
    blob = b"".join(streams)
    sizes = np.asarray([len(s) for s in streams], np.int64)
    offsets = np.zeros(n, np.int64)
    np.cumsum(sizes[:-1], out=offsets[1:])
    nbits = np.ascontiguousarray(nbits, np.int64)
    # clamp declared bits to the bytes actually present
    nbits = np.minimum(nbits, sizes * 8)
    max_step = np.ascontiguousarray(max_step, np.int32)
    mp_ptr, km_ptr, _keep = _mask_ptrs(mask_plane, keep_mask, n)
    out = np.empty((n, h, w), np.float32)
    lib.ebcc_coder_decode_batch(
        ctypes.cast(ctypes.c_char_p(blob), ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        nbits.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        max_step.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        mp_ptr, km_ptr,
        ctypes.c_int(n), ctypes.c_int(h), ctypes.c_int(w),
        ctypes.c_int(group_levels), ctypes.c_int(nplanes),
        ctypes.c_int(nchunks),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def coder_encode_batch_sparse(deltas: np.ndarray, vals: np.ndarray,
                              counts: np.ndarray, shifts: np.ndarray,
                              h: int, w: int, trunc_bits: np.ndarray,
                              group_levels: int, nplanes: int, nchunks: int
                              ) -> np.ndarray:
    """Native bitplane encode from the sparse (delta, value) form."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    deltas = np.ascontiguousarray(deltas, np.uint16)
    vals = np.ascontiguousarray(vals, np.uint16)
    n, kcap = deltas.shape
    counts = np.ascontiguousarray(counts, np.int32)
    shifts = np.ascontiguousarray(shifts, np.int32)
    trunc = np.ascontiguousarray(trunc_bits, np.int64)
    cap_bytes = max(8, (int(trunc.max(initial=0)) + 7) // 8)
    out = np.zeros((n, cap_bytes), np.uint8)
    lib.ebcc_coder_encode_batch_sparse(
        deltas.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        shifts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(kcap),
        ctypes.c_int(n), ctypes.c_int(h), ctypes.c_int(w),
        ctypes.c_int(group_levels), ctypes.c_int(nplanes),
        ctypes.c_int(nchunks),
        trunc.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(cap_bytes))
    return out


def coder_decode_batch_u16(streams: list[bytes], nbits: np.ndarray,
                           max_step: np.ndarray, h: int, w: int,
                           group_levels: int, nplanes: int, nchunks: int,
                           mask_plane: np.ndarray | None = None,
                           keep_mask: np.ndarray | None = None):
    """Native structural decode -> packed u16 state (sign<<15 | last_off<<14
    | mag>>b_end) + per-frame b_end.  Returns (packed, bend, ok); frames
    with ok == 0 need the float32 path."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    n = len(streams)
    blob = b"".join(streams)
    sizes = np.asarray([len(s) for s in streams], np.int64)
    offsets = np.zeros(n, np.int64)
    np.cumsum(sizes[:-1], out=offsets[1:])
    nbits = np.minimum(np.ascontiguousarray(nbits, np.int64), sizes * 8)
    max_step = np.ascontiguousarray(max_step, np.int32)
    mp_ptr, km_ptr, _keep = _mask_ptrs(mask_plane, keep_mask, n)
    out = np.empty((n, h, w), np.uint16)
    bend = np.zeros(n, np.int32)
    ok = np.zeros(n, np.int32)
    lib.ebcc_coder_decode_batch_u16(
        ctypes.cast(ctypes.c_char_p(blob), ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        nbits.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        max_step.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        mp_ptr, km_ptr,
        ctypes.c_int(n), ctypes.c_int(h), ctypes.c_int(w),
        ctypes.c_int(group_levels), ctypes.c_int(nplanes),
        ctypes.c_int(nchunks),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        bend.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out, bend, ok


def bytes_to_words_batch(streams: list[bytes], nwords: int) -> np.ndarray:
    """Byte streams -> zero-padded [n, nwords] u32 word buffers."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    n = len(streams)
    blob = b"".join(streams)
    offsets = np.zeros(n, np.uintp)
    sizes = np.asarray([len(s) for s in streams], np.uintp)
    np.cumsum(sizes[:-1], out=offsets[1:])
    out = np.zeros((n, nwords), np.uint32)
    lib.ebcc_bytes_to_words_batch(
        ctypes.cast(ctypes.c_char_p(blob), ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_size_t)),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_size_t)),
        ctypes.c_int(n),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_int(nwords))
    return out
