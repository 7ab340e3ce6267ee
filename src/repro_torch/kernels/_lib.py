"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` into
``build/kernels/lib<name>.so`` at the repository root (a plain C
interface, loaded with ``ctypes``; no PyTorch headers, so a build takes
seconds).  All sources build in parallel, at first use; a library newer
than its sources is reused.  Nothing here runs when the module is imported.

``LAUNCHES`` counts kernel launches by name.  Each launcher adds one where
it launches its kernel and nowhere else, so a run can show that its main
path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, NamedTuple, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# kernel name (= source csrc/<name>.cu) -> (C entry point, its argument types);
# every entry point returns cudaGetLastError() as an int
SIGNATURES = {
    "flash_attention": ("flash_attention", [_P] * 5 + [_I] * 7 + [_F, _F] + [_I] * 7 + [_P]),
    "flash_attention_bwd": ("flash_attention_bwd", [_P] * 11 + [_I] * 7 + [_F, _F] + [_I] * 6
                            + [_P]),
    "decode_attention": ("decode_attention", [_P] * 4 + [_I, _P, _P] + [_I] * 6 + [_F, _F]
                         + [_I] * 3 + [_P]),
    "paged_attention": ("paged_decode_attention", [_P] * 7 + [_I] * 7 + [_F, _F] + [_I] * 3
                        + [_P]),
    "mamba_scan": ("mamba_scan", [_P] * 11 + [_I] * 10 + [_P]),
    "mamba_scan_bwd": ("mamba_scan_bwd", [_P] * 21 + [_I] * 7 + [_P]),
    "rolling_stats": ("rolling_stats", [_P] * 5 + [_I] * 4 + [_F] * 3 + [_I] * 2 + [_P]),
}
KERNELS = tuple(SIGNATURES)

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
_FNS: Dict[str, ctypes._CFuncPtr] = {}
BUILD_LOG: Dict[str, str] = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(path)


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.glob("*.cu*"))
    return lib.stat().st_mtime < newest


def build_all(force: bool = False) -> float:
    """Compile every stale kernel library, one ``nvcc`` per source, all at
    once.  Returns the wall seconds spent; raises with the compiler's output
    if any build fails."""

    todo = [n for n in KERNELS if force or _stale(n)]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{out}")
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str):
    """The C entry point of kernel ``name``, its argument types set (the
    library is built first if needed, and loaded once)."""

    fn = _FNS.get(name)
    if fn is None:
        if _stale(name):
            build_all()
        symbol, argtypes = SIGNATURES[name]
        fn = getattr(ctypes.CDLL(str(_lib_path(name))), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def check(status: int, name: str) -> None:
    """Raise if a launcher's C function reported a CUDA error."""

    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # the kernels' element types


def check_tensors(first, *rest, align: int = 16):
    """Shared validation of the launchers' tensor arguments: CUDA, one
    device, one dtype, contiguous, ``align``-byte aligned."""

    for t in (first, *rest):
        if t.device.type != "cuda":
            raise ValueError(f"kernel launch needs CUDA tensors, got {t.device}")
        if t.device != first.device:
            raise ValueError("all tensors must be on one device")
        if t.dtype != first.dtype:
            raise TypeError(f"dtype mismatch: {t.dtype} vs {first.dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel tensors must be contiguous")
        if t.data_ptr() % align:
            raise ValueError(f"kernel tensors must be {align}-byte aligned")


def check_attention_args(q, *caches, ints=()) -> int:
    """One pass over an attention launcher's tensors: all CUDA, on q's
    device and contiguous; q and ``caches`` float32 or bfloat16 alike and
    16-byte aligned, ``ints`` int32; head_dim <= 256 and a multiple of 8.
    Returns the kernels' element-type code (0 float32, 1 bfloat16)."""

    dev, dt = q.device, q.dtype
    if dev.type != "cuda":
        raise ValueError(f"kernel launch needs CUDA tensors, got {dev}")
    code = DTYPE_CODES.get(dt)
    if code is None:
        raise TypeError(f"kernels take float32 or bfloat16, got {dt}")
    d = q.shape[-1]
    if d > 256 or d % 8:
        raise ValueError(f"head_dim must be <= 256 and a multiple of 8, got {d}")
    for want, align, ts in ((dt, 16, (q, *caches)), (torch.int32, 4, ints)):
        for t in ts:
            if t.device != dev:
                raise ValueError(f"kernel launch needs CUDA tensors on {dev}, got {t.device}")
            if t.dtype != want:
                raise TypeError(f"expected {want}, got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError("kernel tensors must be contiguous")
            if t.data_ptr() % align:
                raise ValueError(f"kernel tensors must be {align}-byte aligned")
    return code


# Splitting a decode call's KV length over blocks (flash-decoding).  A
# block's work is its tokens times the G query heads it serves: aim for
# CTAS_PER_SM blocks on each of the H100's SMS, each with at least
# MIN_SPLIT token-heads and at most MAX_SPLIT tokens (the paged kernel keeps
# a block's page-table entries in shared memory).  Measured on an H100
# (PERF.md): below ~128 tokens at G = 1 one block a row beats a split,
# whose combine kernel costs more than the split saves.
SMS, CTAS_PER_SM, MIN_SPLIT, MAX_SPLIT = 132, 8, 128, 4096


def decode_splits(pairs: int, group: int, max_len: int, gran: int = 16):
    """-> (n_split, split_len) for a decode call over ``pairs`` (row, KV
    head) pairs of ``group`` query heads each, whose rows hold at most
    ``max_len`` tokens: ranges ``[i * split_len, (i + 1) * split_len)``,
    ``i < n_split``, cover ``[0, max_len)`` and each starts on a multiple of
    ``gran`` (the page size for the paged kernel).  Host integers only:
    nothing is read from the device, so the launch can be captured in a
    CUDA graph."""

    if type(pairs) is not int or type(group) is not int or type(max_len) is not int \
            or type(gran) is not int:
        raise TypeError(f"decode_splits takes host ints, got {pairs!r}, {group!r}, "
                        f"{max_len!r}, {gran!r}")
    return _plan(pairs, group, max_len, gran)


@functools.lru_cache(maxsize=4096)
def _plan(pairs, group, max_len, gran):
    max_len = max(max_len, 1)
    work = max(pairs * group, 1)
    n = min(-(-SMS * CTAS_PER_SM // work), -(-max_len // -(-MIN_SPLIT // max(group, 1))))
    n = max(n, -(-max_len // MAX_SPLIT), 1)
    split_len = -(-max_len // n)
    split_len = -(-split_len // gran) * gran
    return -(-max_len // split_len), split_len


def decode_workspace(q, pairs: int, n_split: int, g: int, d: int):
    """The float32 partials of a split decode call, (m, l, o[G, D]) per
    (pair, split); None when n_split == 1 (the kernel writes the output)."""

    if n_split == 1:
        return None
    return torch.empty(pairs * n_split * g * (d + 2), dtype=torch.float32, device=q.device)


# The prefill kernel's tile plan.  In bf16 (tensor cores) a block takes
# ``rows`` = 16 x m-tiles x ``warps`` packed rows of one (batch row, KV head) pair:
# packed row r is position r // G of query head kvh * G + r % G, so the G
# query heads of a KV head share each K/V tile.  Blocks run longest first:
# linear block L is pair L % pairs, query tile tiles - 1 - L // pairs.  The
# float32 (SIMT) kernel keeps one block per (16 positions, query head,
# batch row).  A block visits key tiles of ``key_tile`` keys from its
# window's lower bound up to its last row's causal limit.
FLASH_SHAPES = ((2, 4), (1, 4), (1, 2), (1, 1))  # (m-tiles a warp, warps), first fit
FLASH_F32_ROWS, FLASH_F32_WARPS, FLASH_F32_KEYS = 16, 4, 32


class FlashPlan(NamedTuple):
    packed: bool                # tensor cores: rows packed over the G heads of a KV head
    rows: int                   # packed rows (bf16) or positions (float32) a block takes
    warps: int                  # warps a block has
    key_tile: int               # keys a K/V tile holds
    grid: Tuple[int, int, int]  # the launch grid
    tiles: int                  # query tiles a (row, KV head) pair (bf16) or a head (f32)
    group: int                  # G = H / KV


def flash_plan(b: int, s: int, h: int, kv: int, d: int, dtype) -> FlashPlan:
    """The launch plan of the prefill kernel for q [b, s, h, d] and k/v
    [b, s, kv, d].  Host integers only (a CUDA graph can capture the launch);
    cached.  bf16: the most warps (at most 4, none idle) whose blocks still
    number at least ``SMS``, else one warp a block, so that short prompts
    spread over the SMs; a warp owns two m-tiles of 16 rows where the
    blocks still cover the SMs (long prompts) and D <= 128."""

    for x in (b, s, h, kv, d):
        if type(x) is not int:
            raise TypeError(f"flash_plan takes host ints, got {x!r}")
    if dtype not in DTYPE_CODES:
        raise TypeError(f"flash_plan: float32 or bfloat16, got {dtype!r}")
    if min(b, s, h, kv, d) < 1 or h % kv:
        raise ValueError(f"flash_plan: bad shape b={b} s={s} h={h} kv={kv} d={d}")
    return _flash_plan(b, s, h, kv, d, dtype == torch.bfloat16)


@functools.lru_cache(maxsize=4096)
def _flash_plan(b, s, h, kv, d, tensor_cores):
    g = h // kv
    if not tensor_cores:
        tiles = -(-s // FLASH_F32_ROWS)
        return FlashPlan(False, FLASH_F32_ROWS, FLASH_F32_WARPS, FLASH_F32_KEYS, (tiles, h, b),
                         tiles, g)
    rows_total, pairs, dk = s * g, b * kv, -(-d // 16) * 16
    # (m-tiles a warp, warps): two m-tiles share every K/V fragment a warp
    # loads (D <= 128 only: registers); no warp idle
    shapes = [(mt, w) for mt, w in FLASH_SHAPES
              if (mt == 1 or dk <= 128) and 16 * mt * (w - 1) < rows_total]
    for mt, warps in shapes:
        tiles = -(-rows_total // (16 * mt * warps))
        if pairs * tiles >= SMS:
            break
    key_tile = 64 if dk <= 128 else 32
    return FlashPlan(True, 16 * mt * warps, warps, key_tile, (tiles * pairs, 1, 1), tiles, g)


# The training backward's plan (csrc/flash_attention_bwd.cu).  Rows are
# packed over the G heads of a KV head, as the prefill kernel packs them.
# bf16 (tensor cores): a dk / dv block takes ``k_tile`` keys (64; 32 where
# D > 128) of one (batch row, KV head) and one of ``splits`` groups of G /
# splits query heads, and walks its visible packed rows ``k_tile`` at a
# time; ``splits`` is the smallest divisor of G whose grid reaches ``SMS``
# blocks (else G), and with splits > 1 the blocks write float32 partials
# that a reduce pass sums.  A dq block takes ``q_tile`` = 64 packed rows and
# walks the key tiles they see; the dk / dv and dq blocks share one launch
# (``grid_dkdv + grid_dq`` blocks).  float32 (scalar kernels): tiles of 32
# keys and 32 packed rows, no split, dk / dv and dq in two launches.  Every
# call launches delta = rowsum(dout * out) first.
BWD_TC_Q_TILE, BWD_F32_TILE = 64, 32


class FlashBwdPlan(NamedTuple):
    tensor_cores: bool  # bf16 mma.sync kernels (else the float32 scalar ones)
    q_tile: int         # packed query rows a dq block takes
    k_tile: int         # keys a dk / dv block takes, packed rows it walks a step, a dq key tile
    splits: int         # dk / dv blocks a (batch row, KV head, key tile)
    q_tiles: int        # ceil(S * G / q_tile)
    k_tiles: int        # ceil(S / k_tile)
    grid_dq: int        # q_tiles * B * KV blocks
    grid_dkdv: int      # k_tiles * B * KV * splits blocks
    group: int          # G = H / KV


def flash_bwd_plan(b: int, s: int, h: int, kv: int, d: int, dtype) -> FlashBwdPlan:
    """The launch plan of the flash backward for q [b, s, h, d] and k/v
    [b, s, kv, d] of ``dtype``.  Host integers only; cached."""

    for x in (b, s, h, kv, d):
        if type(x) is not int:
            raise TypeError(f"flash_bwd_plan takes host ints, got {x!r}")
    if dtype not in DTYPE_CODES:
        raise TypeError(f"flash_bwd_plan: float32 or bfloat16, got {dtype!r}")
    if min(b, s, h, kv, d) < 1 or h % kv:
        raise ValueError(f"flash_bwd_plan: bad shape b={b} s={s} h={h} kv={kv} d={d}")
    return _flash_bwd_plan(b, s, h, kv, d, dtype == torch.bfloat16)


@functools.lru_cache(maxsize=4096)
def _flash_bwd_plan(b, s, h, kv, d, tensor_cores):
    g, pairs = h // kv, b * kv
    if tensor_cores:
        q_tile = BWD_TC_Q_TILE
        k_tile = 64 if -(-d // 16) * 16 <= 128 else 32
    else:
        q_tile = k_tile = BWD_F32_TILE
    q_tiles, k_tiles = -(-s * g // q_tile), -(-s // k_tile)
    splits = 1
    if tensor_cores:
        splits = next((n for n in range(1, g + 1) if g % n == 0 and k_tiles * pairs * n >= SMS), g)
    return FlashBwdPlan(tensor_cores, q_tile, k_tile, splits, q_tiles, k_tiles,
                        q_tiles * pairs, k_tiles * pairs * splits, g)


# The Mamba scan's plan (csrc/mamba_scan.cu).  A chunk of L steps is cut into
# row tiles of ``rows`` = 16, 32 or 64 query steps (the chunk's class); a
# block takes ``heads`` consecutive heads of one (batch row, chunk), so G =
# C B^T of a row tile is built once for them.  Scan block ``i`` (linear) is
# row tile ``row_tiles - 1 - i % row_tiles`` of group ``(i // row_tiles) %
# groups`` of (batch row, chunk) ``i // (row_tiles * groups)`` (b * chunks +
# c); state block ``j`` is group ``j % groups`` of (batch row, chunk) ``j //
# groups``.  A thread owns 4 x 4 outputs: 4 rows x 4 channels of y, or 4
# channels x 4 state columns of sc; ``threads`` covers a head's tile (P and N
# padded to multiples of 4) for as many heads at once as fit.
MAMBA_HEADS = (4, 2, 1)  # heads a block, most first; the most that still fills the SMs


class MambaPlan(NamedTuple):
    chunk: int         # L = min(chunk, S)
    chunks: int        # S // L
    rows: int          # query rows a scan tile
    row_tiles: int     # ceil(L / rows)
    heads: int         # heads a block
    groups: int        # ceil(H / heads)
    threads: int       # threads a block
    scan_blocks: int   # row_tiles * B * chunks * groups
    state_blocks: int  # B * chunks * groups
    fused: bool        # one chunk: scan and state blocks in one launch, no pass


def mamba_plan(b: int, s: int, h: int, p: int, n: int, chunk: int) -> MambaPlan:
    """The launch plan of the Mamba scan for x [b, s, h, p], B/C [b, s, n]
    and ``chunk``.  Host integers only (a CUDA graph can capture the
    launch); cached.  The most heads a block (at most 4) whose launch still
    has at least ``SMS`` blocks, else one; threads: the next power of two
    >= a head's 4 x 4 tiles times the heads, in [32, 256]."""

    for x in (b, s, h, p, n, chunk):
        if type(x) is not int:
            raise TypeError(f"mamba_plan takes host ints, got {x!r}")
    if min(b, s, h, p, n, chunk) < 1:
        raise ValueError(f"mamba_plan: bad shape b={b} s={s} h={h} p={p} n={n} chunk={chunk}")
    return _mamba_plan(b, s, h, p, n, chunk)


@functools.lru_cache(maxsize=4096)
def _mamba_plan(b, s, h, p, n, chunk):
    L = min(chunk, s)
    nc = s // L
    rows = 16 if L <= 16 else 32 if L <= 32 else 64
    row_tiles = -(-L // rows)
    p4, n4 = -(-p // 4) * 4, -(-n // 4) * 4
    units = max(rows // 4 * (p4 // 4), p4 // 4 * (n4 // 4))
    for heads in MAMBA_HEADS:
        groups = -(-h // heads)
        blocks = (row_tiles + (nc == 1)) * b * nc * groups
        if blocks >= SMS:
            break
    threads = 32
    while threads < min(units * heads, 256):
        threads *= 2
    return MambaPlan(L, nc, rows, row_tiles, heads, groups, threads,
                     row_tiles * b * nc * groups, b * nc * groups, nc == 1)


# The Mamba scan backward's plan (csrc/mamba_scan_bwd.cu).  Three launches:
# state blocks, one a (batch row, pair of heads), over its chunks in reverse
# (dS, dh_out, dh0); chunk blocks, each ``rows`` = 64 steps s of one (batch row,
# chunk) and ``heads`` consecutive heads, walking the chunk's steps t >= its
# first s in tiles of 64 (G = C B^T of a tile built once for the block's
# heads, and dB / dC taken once from the heads' sum of Q); then the reduce:
# one block a head (dcum -> ddt, da), the rest summing the chunk blocks'
# partials of dB and dC, 32 elements a block.  Chunk block ``i`` (linear)
# is row tile ``i // (B * chunks * groups)`` -- the tiles with the most
# steps after them first -- of group ``i % groups`` of (batch row, chunk)
# ``i // groups % (B * chunks)``.
BWD_ROWS, BWD_HEADS, BWD_STATE_HEADS, BWD_REDUCE_ELEMS = 64, (2, 1), 2, 32


class MambaBwdPlan(NamedTuple):
    chunk: int          # L = min(chunk, S)
    chunks: int         # S // L
    row_tiles: int      # ceil(L / 64)
    heads: int          # heads a chunk block
    groups: int         # ceil(H / heads)
    chunk_blocks: int   # row_tiles * B * chunks * groups
    state_blocks: int   # B * ceil(H / 2)
    reduce_blocks: int  # H + ceil(B * S * N / 32)


def mamba_bwd_plan(b: int, s: int, h: int, p: int, n: int, chunk: int) -> MambaBwdPlan:
    """The launch plan of the Mamba scan backward for x [b, s, h, p], B/C
    [b, s, n] and ``chunk``.  Host integers only (a CUDA graph can capture
    the launches); cached.  The most heads a chunk block (at most 2) whose
    launch still has at least ``SMS`` blocks, else one."""

    for x in (b, s, h, p, n, chunk):
        if type(x) is not int:
            raise TypeError(f"mamba_bwd_plan takes host ints, got {x!r}")
    if min(b, s, h, p, n, chunk) < 1:
        raise ValueError(f"mamba_bwd_plan: bad shape b={b} s={s} h={h} p={p} n={n} "
                         f"chunk={chunk}")
    return _mamba_bwd_plan(b, s, h, p, n, chunk)


@functools.lru_cache(maxsize=4096)
def _mamba_bwd_plan(b, s, h, p, n, chunk):
    L = min(chunk, s)
    nc = s // L
    row_tiles = -(-L // BWD_ROWS)
    for heads in BWD_HEADS:
        groups = -(-h // heads)
        if row_tiles * b * nc * groups >= SMS:
            break
    return MambaBwdPlan(L, nc, row_tiles, heads, groups, row_tiles * b * nc * groups,
                        b * -(-h // BWD_STATE_HEADS),
                        h + -(-b * s * n // BWD_REDUCE_ELEMS))
