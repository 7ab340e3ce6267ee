"""Device meshes (counterpart of ``repro/launch/mesh.py``).

A ``Mesh`` is an ndarray of ``torch.device`` with named axes, built by a
function, never at import, as the reference builds its meshes.  The port
runs eagerly, so a mesh does not place anything: it names the shards that
the logical rules (``launch/sharding.py``) lay arrays out over, and the
scheduler splits its page pool and decode rows over the ``data`` axis.  A
device may appear more than once, so that ``data`` shards can live on one
CPU (the tests) or on one card (``chip_smoke.py``).

A rank mesh (``make_rank_mesh``) is one rank's view of a mesh whose
``model`` axis is a ``torch.distributed`` group (``launch/dist.py``): it
holds the group and its own rank, and column ``m`` of its devices is rank
``m``'s device, once a data shard.  Over a rank grid
(``launch.dist.RankGrid``) the ``data`` axis is ranks too: row ``d``,
column ``m`` is rank ``(d, m)``'s own device, and the mesh holds the grid,
the rank's data group and its batch group (the ranks its rows are blocked
over); a grid with a ``pod`` axis gives a (pod, data, model) mesh whose
rows are blocked over every (pod, data) rank; a prefill rank's mesh holds
the grid alone.  A mesh of one process has no group and rank 0.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """``devices``: an ndarray of ``torch.device`` shaped like the mesh;
    ``axis_names``: one name per axis; ``shape``: ``{axis: size}``;
    ``group``: the ``model`` axis's ranks (``launch.dist.ModelGroup``; None
    in one process), and ``rank``, this process's place on it;
    ``data_group``: the ``data`` axis's ranks where they are processes
    (None where the data shards share this process's device), and
    ``grid``, the ``launch.dist.RankGrid`` the mesh lies on (None in one
    process); ``batch_group``: the ranks the rows are blocked over (the
    data group, or every (pod, data) rank of a pod grid; None in one
    process)."""

    def __init__(self, devices, axis_names: Sequence[str], group=None, data_group=None,
                 grid=None, batch_group=None):
        flat = [torch.device(d) for d in np.asarray(devices, dtype=object).reshape(-1)]
        shape = np.asarray(devices, dtype=object).shape
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh of shape {shape} needs {len(shape)} axis names, "
                             f"got {tuple(axis_names)}")
        self.devices = np.empty(len(flat), dtype=object)
        self.devices[:] = flat
        self.devices = self.devices.reshape(shape)
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, shape))
        self.group = group
        self.data_group = data_group if data_group is not None and data_group.size > 1 else None
        self.batch_group = (batch_group if batch_group is not None and batch_group.size > 1
                            else None)
        self.grid = grid

    @property
    def rank(self) -> int:
        return self.group.rank if self.group is not None else 0

    @property
    def data_rank(self) -> int:
        """This process's place on the data axis (0 in one process)."""

        return self.data_group.rank if self.data_group is not None else 0

    @property
    def local_shards(self) -> int:
        """The data shards this process holds: every one in one process (a
        pod axis folded into them), 1 where the rows are blocked over
        ranks."""

        return 1 if self.batch_group is not None else int(self.shape.get("data", 1))

    @property
    def prefill_rank(self) -> bool:
        """Whether this process is the grid's prefill rank."""

        return self.grid is not None and self.grid.is_prefill

    @property
    def distinct_devices(self) -> List[torch.device]:
        """The mesh's devices, each once, in mesh order."""

        out: List[torch.device] = []
        for d in self.devices.reshape(-1):
            if d not in out:
                out.append(d)
        return out


def host_devices(device: str = "cuda") -> List[torch.device]:
    """Every card (``device="cuda"``; none raises) or ``[cpu]``."""

    if torch.device(device).type == "cuda":
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device: pass device='cpu'")
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cpu")]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production shapes, (16, 16) over ("data", "model")
    or (2, 16, 16) over ("pod", "data", "model"), on the meta device: only
    the shape is meant (a dry run's layout), no machine here holds it."""

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    devs = np.empty(int(np.prod(shape)), dtype=object)
    devs[:] = [torch.device("meta")] * devs.size
    return Mesh(devs.reshape(shape), axes)


def make_host_mesh(*, model: int = 1, device: str = "cuda") -> Mesh:
    """Mesh over every device there is: the cards (``device="cuda"``) or
    the CPU.  ``model`` asks for a model axis; it shrinks to the largest
    divisor of the device count at most the request, so any count factors
    into a (data, model) rectangle (``model=4`` on 6 devices -> (2, 3))."""

    devs = host_devices(device)
    n = len(devs)
    m = max(1, min(model, n))
    while n % m:
        m -= 1
    return Mesh(np.asarray(devs, dtype=object).reshape(n // m, m), ("data", "model"))


def make_test_mesh(*, data: int, model: int = 1, devices: Optional[Sequence] = None,
                   device: str = "cuda") -> Mesh:
    """Exact-shape (data, model) mesh over ``devices`` (default: every
    device of ``device``'s kind); raises when their count is not ``data *
    model``.  A device may repeat: ``devices=[torch.device("cpu")] * 8``
    gives 8 data shards on the CPU, ``[cuda:0] * 2`` two on one card."""

    devs = [torch.device(d) for d in devices] if devices is not None else host_devices(device)
    if data * model != len(devs):
        raise ValueError(f"make_test_mesh(data={data}, model={model}) needs {data * model} "
                         f"devices but found {len(devs)}; pass devices= (a device may repeat, "
                         f"e.g. [torch.device('cpu')] * {data * model})")
    return Mesh(np.asarray(devs, dtype=object).reshape(data, model), ("data", "model"))


def make_rank_mesh(data: int, group) -> Mesh:
    """A (data, model) mesh whose ``model`` axis is ranks.  ``group`` a
    ``launch.dist.ModelGroup``: column ``m`` is rank ``m``'s device,
    repeated ``data`` times (the data shards of one device, as
    ``make_test_mesh`` repeats a device).  ``group`` a
    ``launch.dist.RankGrid`` of ``data`` data ranks: row ``d``, column
    ``m`` is rank ``(d, m)``'s device, and the mesh holds the grid, the
    rank's model group, its data group and its batch group (a prefill
    rank's: none); a grid with a ``pod`` axis above 1 gives a (pod, data,
    model) mesh over ``("pod", "data", "model")``, entry ``(p, d, m)``
    rank ``(p, d, m)``'s device.  The mesh keeps the group and this
    process's rank."""

    if data < 1:
        raise ValueError(f"data={data}: at least 1")
    from repro_torch.launch.dist import RankGrid

    if isinstance(group, RankGrid):
        if data != group.data:
            raise ValueError(f"data={data} on a grid of {group.data} data ranks")
        n = group.decode_ranks
        devs = np.empty(n, dtype=object)
        devs[:] = [torch.device(d) for d in group.devices[:n]]
        mg = group.model_group if group.model_group is not None and group.model > 1 else None
        if group.pod > 1:
            shape, axes = (group.pod, group.data, group.model), ("pod", "data", "model")
        else:
            shape, axes = (group.data, group.model), ("data", "model")
        return Mesh(devs.reshape(shape), axes, group=mg, data_group=group.data_group, grid=group,
                    batch_group=group.batch_group)
    devs = np.empty((data, group.size), dtype=object)
    for m, d in enumerate(group.devices):
        devs[:, m] = [torch.device(d)] * data
    return Mesh(devs, ("data", "model"), group=group)


def split_device_groups(*, prefill: int = 1, device: str = "cuda"
                        ) -> Tuple[List[torch.device], List[torch.device]]:
    """(prefill devices, decode devices) for disaggregated serving: the
    last ``prefill`` devices prefill, so decode keeps the first.  With no
    more devices than ``prefill`` both groups are all of them (one card:
    the prefill still runs on a stream of its own, beside the decode)."""

    devs = host_devices(device)
    if len(devs) <= prefill:
        return list(devs), list(devs)
    return list(devs[-prefill:]), list(devs[:-prefill])
