"""Logical-axis sharding rules with a divisibility guard (counterpart of
``repro/launch/sharding.py``).

Arrays are described by *logical* axis names ("batch", "heads", "pages",
...); ``DEFAULT_RULES`` maps each name to mesh axes, and
``logical_to_pspec`` turns a shape and its names into a ``PartitionSpec``,
**dropping any mapping whose dimension does not divide by the mesh-axis
product** (e.g. starcoder2's 24 heads over a 16-way model axis) and using
each mesh axis at most once.  ``shard_shape`` gives one shard's local
shape under a spec, and ``local_slice`` a rank's block of a global tensor
over the ``model`` axis of a rank mesh (``launch/mesh.py``).

The port runs eagerly, not under GSPMD: ``shard(x, *axes)`` returns ``x``
itself.  The ``sharding_rules`` context makes a mesh active
(``active_mesh``): the paged decode attention reads it and splits its rows
over the ``data`` axis (``kernels.paged_attention.
paged_decode_attention_sharded``), and where the rows are blocked over
ranks (the data ranks, or every (pod, data) rank of a pod grid) the MoE
layers read from it that the rows they see are the rank's block
(``rows_group``) and which of the blocks' rows are real (``rows_layout``);
``no_sharding`` suspends it.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

MeshAxes = Union[str, Tuple[str, ...], None]

# logical name -> mesh axes on the production mesh; a multi-pod mesh adds
# "pod" to the batch mapping
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("data",),
    "seq": (),            # sequence replicated by default (overridable)
    "embed": (),          # d_model replicated on activations
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "qkv_features": ("model",),   # flattened heads*head_dim on weights
    "mlp": ("model",),
    # expert parallelism rides the data axis, leaving "model" free to shard
    # each expert's FFN hidden
    "expert": ("data",),
    "vocab": ("model",),
    "kv_seq": (),         # kv-cache sequence dim (sharded for long context)
    # the paged KV pool's page dim: page ids are global, each data shard
    # owns a contiguous [P+1]/ndata block (the trash page on the last shard)
    "pages": ("data",),
    "state": ("model",),  # ssm / xlstm inner feature dim
    "conv": (),
}

MULTIPOD_BATCH = ("pod", "data")


class PartitionSpec(tuple):
    """One mesh-axis entry per array dimension: a name, a tuple of names,
    or None (replicated).  A tuple, so specs compare as tuples."""

    def __new__(cls, *entries: MeshAxes):
        return super().__new__(cls, entries)


P = PartitionSpec


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: Optional[Dict[str, Tuple[str, ...]]] = None
        self.rows: Optional[Tuple[Tuple[int, int], ...]] = None


_CTX = _Ctx()


def make_rules(mesh, overrides: Optional[Dict[str, Tuple[str, ...]]] = None):
    rules = dict(DEFAULT_RULES)
    if "pod" in mesh.axis_names:
        rules["batch"] = MULTIPOD_BATCH
    if overrides:
        rules.update(overrides)
    return rules


@contextlib.contextmanager
def sharding_rules(mesh, overrides: Optional[Dict[str, Tuple[str, ...]]] = None,
                   rows: Optional[Sequence[Tuple[int, int]]] = None):
    """Make ``mesh`` (and its rules) active for the calls inside.
    ``rows``: the row buffers the calls' rows are made of, each as
    ``(global rows R, rows a block B)`` in the order they are joined
    (``rows_layout``; None: every row of every block is real)."""

    prev = (_CTX.mesh, _CTX.rules, _CTX.rows)
    _CTX.mesh, _CTX.rules = mesh, make_rules(mesh, overrides)
    _CTX.rows = tuple(rows) if rows is not None else None
    try:
        yield _CTX.rules
    finally:
        _CTX.mesh, _CTX.rules, _CTX.rows = prev


@contextlib.contextmanager
def no_sharding():
    """Suspend any active mesh (the disaggregated prefill runs so)."""

    prev = (_CTX.mesh, _CTX.rules, _CTX.rows)
    _CTX.mesh, _CTX.rules, _CTX.rows = None, None, None
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules, _CTX.rows = prev


@contextlib.contextmanager
def rows_scope(rows: Optional[Sequence[Tuple[int, int]]]):
    """``rows`` ((R, B) each) in place of the active ``sharding_rules``'
    for the calls inside (a fused split round's lane's edge layers see that
    lane's block alone); nothing where ``rows`` is None."""

    if rows is None:
        yield
        return
    prev, _CTX.rows = _CTX.rows, tuple(rows)
    try:
        yield
    finally:
        _CTX.rows = prev


def active_mesh():
    """The mesh of the innermost ``sharding_rules``, or None."""

    return _CTX.mesh


def rows_group():
    """The ranks whose blocks of rows the calls inside see (the active
    mesh's ``batch_group``: the data ranks, or every (pod, data) rank of a
    pod grid, in a scheduler's decode round or fused split round), or None
    where every rank sees every row."""

    return getattr(_CTX.mesh, "batch_group", None)


def rows_layout() -> Optional[Tuple[Tuple[int, int], ...]]:
    """The active ``sharding_rules``' ``rows``: ``((R, B), ...)``, one a
    row buffer joined into the calls' rows (the cloud rows, or each lane of
    a fused split round in order), each a padded block of ``B = ceil(R /
    ranks)`` rows a rank; rank ``k``'s block holds global rows ``[k B,
    (k + 1) B)``, those at ``R`` and above padding.  None: no padding."""

    return _CTX.rows


def real_rows(local: int, ranks: int) -> Optional[List[int]]:
    """The positions, in the concatenation of ``ranks`` ranks' ``local``
    rows each (rank order), of the real rows in their global order: the
    row buffers of ``rows_layout`` whose blocks add up to ``local`` (a
    prefix: a fused round's tail joins the lanes in order), each buffer's
    rows in turn -> None where every position is real and in order."""

    layout = rows_layout()
    if layout is None:
        return None
    seg, total = [], 0
    for r, b in layout:
        if total == local:
            break
        seg.append((r, b, total))
        total += b
    if total != local:
        raise ValueError(f"{local} rows a rank are no prefix of the blocks {layout}")
    out = [k * local + off + i for r, b, off in seg for k in range(ranks) for i in range(b)
           if k * b + i < r]
    return None if out == list(range(ranks * local)) else out


def _axis_size(mesh, axes: Tuple[str, ...]) -> int:
    return math.prod(mesh.shape[a] for a in axes) if axes else 1


def logical_to_pspec(shape: Sequence[int], logical_axes: Sequence[Optional[str]], mesh,
                     rules: Optional[Dict[str, Tuple[str, ...]]] = None) -> PartitionSpec:
    """A ``PartitionSpec`` for ``shape`` from logical axis names: a name
    maps to its mesh axes only if the dim divides by their product, else
    the dim stays unsharded; a mesh axis is used at most once (the first
    dim that claims it wins)."""

    rules = rules or make_rules(mesh)
    if len(shape) != len(logical_axes):
        raise ValueError(f"shape {tuple(shape)} and logical axes {tuple(logical_axes)} differ "
                         "in length")
    used: set = set()
    spec = []
    for dim, name in zip(shape, logical_axes):
        entry: MeshAxes = None
        if name is not None:
            axes = tuple(a for a in rules.get(name, ()) if a not in used)
            if axes and dim % _axis_size(mesh, axes) == 0:
                entry = axes if len(axes) > 1 else axes[0]
                used.update(axes)
        spec.append(entry)
    return PartitionSpec(*spec)


def shard(x, *logical_axes: Optional[str]):
    """The identity: the port places nothing by annotation."""

    return x


def shard_shape(mesh, shape: Sequence[int], pspec: Sequence[MeshAxes]) -> Tuple[int, ...]:
    """One shard's local shape of an array of ``shape`` laid out by
    ``pspec`` over ``mesh`` (each sharded dim divided by its axes' size)."""

    out = []
    for dim, entry in zip(shape, tuple(pspec) + (None,) * (len(shape) - len(pspec))):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        n = _axis_size(mesh, axes)
        if dim % n:
            raise ValueError(f"dim {dim} does not divide over {axes} ({n} shards)")
        out.append(dim // n)
    return tuple(out)


def local_index(shape: Sequence[int], pspec: Sequence[MeshAxes], mesh, rank: int,
                parts: Sequence[int] = ()) -> Tuple[object, ...]:
    """The index of model-axis rank ``rank``'s block of an array of
    ``shape`` laid out by ``pspec`` over ``mesh``: a dim that ``pspec``
    maps to ``"model"`` is cut into ``mesh.shape["model"]`` contiguous
    blocks and the rank keeps block ``rank``; a dim mapped to ``"data"``
    is cut so, block ``mesh.data_rank``, where the data axis is ranks
    (``mesh.data_group``); every other dim is whole (a rank holds each of
    its data shards' blocks where they share its device).  A dim mapped to
    more than one axis raises.

    ``parts[i]`` (default 1): dim ``i`` is that many equal parts laid end
    to end, each cut so (Mamba's ``in_proj``, x | z): its entry is the
    list of the positions of the rank's block of every part, in order,
    where one part gives a slice."""

    ranks = {"model": (int(mesh.shape.get("model", 1)), rank)}
    if getattr(mesh, "data_group", None) is not None:
        ranks["data"] = (int(mesh.shape["data"]), mesh.data_rank)
    parts = tuple(parts) + (1,) * (len(shape) - len(parts))
    out = []
    for dim, entry, k in zip(shape, tuple(pspec) + (None,) * (len(shape) - len(pspec)), parts):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        cut = [a for a in axes if a in ranks and ranks[a][0] > 1]
        if not cut:
            out.append(slice(None))
            continue
        if len(axes) > 1:
            raise ValueError(f"dim {dim} over {axes}: a rank holds a model-axis block only (or a "
                             "data-axis one where the data axis is ranks)")
        m, r = ranks[cut[0]]
        if dim % (m * k):
            raise ValueError(f"dim {dim} in {k} parts does not divide over the {cut[0]} axis "
                             f"({m} ranks)")
        n, part = dim // (m * k), dim // k
        if k == 1:
            out.append(slice(r * n, (r + 1) * n))
        else:
            out.append([j * part + r * n + i for j in range(k) for i in range(n)])
    return tuple(out)


def index_extent(dim: int, entry) -> int:
    """The length of ``local_index``'s ``entry`` over a dim of ``dim``."""

    return len(range(dim)[entry]) if isinstance(entry, slice) else len(entry)


def local_slice(t, pspec: Sequence[MeshAxes], mesh, rank: int):
    """Rank ``rank``'s block of the global tensor ``t`` under ``pspec``
    (``logical_to_pspec``'s, whose divisibility guard decides which dims
    are cut) -> a view of ``t`` (``local_index``)."""

    return t[local_index(t.shape, pspec, mesh, rank)]


def _leaf(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (int, str, type(None))) for e in x)


def pspec_tree(shapes_tree, logical_tree, mesh, rules=None):
    """``logical_to_pspec`` over parallel trees (dicts, lists, tuples) of
    shapes and logical axes; a leaf is a flat tuple of ints or of names."""

    if _leaf(shapes_tree):
        return logical_to_pspec(shapes_tree, logical_tree, mesh, rules)
    if isinstance(shapes_tree, dict):
        return {k: pspec_tree(shapes_tree[k], logical_tree[k], mesh, rules) for k in shapes_tree}
    return type(shapes_tree)(pspec_tree(s, lg, mesh, rules)
                             for s, lg in zip(shapes_tree, logical_tree))
