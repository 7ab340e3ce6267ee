"""CUDA graphs for the serving loops: the port's counterpart of the
reference's ``jax.jit`` over a decode chunk or a scan window.

A graph replays a whole chunk (or decode round) of kernels with one host
call, where the eager chain issues each of its thousands of launches from
Python.  ``GraphedCall`` wraps a function of the caller's static buffers.
"""

from __future__ import annotations

import weakref

import torch

from repro_torch.kernels import _lib
from repro_torch.launch import dist
from repro_torch.obs.clock import clock


def _counters():
    """What a replay runs without running Python, as counted: the kernel
    launches, the collectives (an NCCL group's) and their bytes, the model
    axis's and the data axis's."""

    return _lib.LAUNCHES, dist.CALLS, dist.BYTES, dist.DATA_CALLS, dist.DATA_BYTES


class GraphedCall:
    """``fn()`` replayed as one CUDA graph.

    The first call runs ``fn`` eagerly (a real call: the kernels it reaches
    load and the library workspaces it needs are set up on the way) and
    then captures it; every later call replays the graph.  ``fn`` may read
    and write only tensors that outlive the graph (the caller's static
    buffers, updated in place) and host values that stay the same from call
    to call.  A replay returns the tensors that ``fn`` returned at capture:
    the next replay overwrites them.

    The kernel launchers count their launches in Python (``_lib.LAUNCHES``),
    which a replay does not run: the counts that the capture added are
    taken back after it (a capture launches nothing) and added again at
    each replay, so the counts stay those of the kernels that ran
    (``launches``).  The collectives' counts and bytes (``dist.CALLS``,
    ``dist.BYTES``; the data axis's ``dist.DATA_CALLS``, ``DATA_BYTES``)
    are kept so too (``collectives``, ``collective_bytes``,
    ``data_collectives``, ``data_collective_bytes``).
    """

    def __init__(self, fn):
        self.fn = fn
        self.graph = None
        self.out = None
        self.launches = {}
        self.collectives = {}
        self.collective_bytes = {}
        self.data_collectives = {}
        self.data_collective_bytes = {}
        self.capture_s = 0.0
        self.replays = 0

    def __call__(self):
        if self.graph is None:
            out = self.fn()
            self._capture()
            return out
        self.graph.replay()
        self.replays += 1
        for counter, added in zip(_counters(), self._added()):
            for name, n in added.items():
                counter[name] += n
        return self.out

    def _capture(self) -> None:
        counters = _counters()
        before = [dict(c) for c in counters]
        t0 = clock()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.out = self.fn()
        self.capture_s = clock() - t0
        (self.launches, self.collectives, self.collective_bytes, self.data_collectives,
         self.data_collective_bytes) = ({k: n - b[k] for k, n in c.items() if n != b[k]}
                                        for c, b in zip(counters, before))
        for c, b in zip(counters, before):
            c.update(b)
        self.graph = graph

    def _added(self):
        return (self.launches, self.collectives, self.collective_bytes, self.data_collectives,
                self.data_collective_bytes)


def owner_call(owner, name: str, *args):
    """``getattr(owner, name)(*args)`` through a weak reference to ``owner``:
    the function an owner (a policy, a scheduler) gives the
    ``GraphedCall``s it keeps.  A closure over the owner itself would make a
    cycle (owner -> graphs -> function -> owner), and a dropped owner would
    then free its graphs only when the cyclic collector ran, perhaps in the
    middle of another capture, which a graph freed there invalidates.
    Without the cycle the graphs go with the owner's last reference."""

    ref = weakref.ref(owner)
    return lambda: getattr(ref(), name)(*args)
