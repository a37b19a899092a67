"""--shardMode global launches that do not wait for the device.

GlobalScanModel's launches return before the local result exists, as
the JAX package's global launches do; the result gathers are issued by
one thread a process in launch order, whatever order each process drains
its handles in; a failure on that thread is raised where the handles are
read, on every process, within the collective timeout, and no thread is
left after mesh.shutdown_distributed.  The children of the gloo tests run
with jax and the JAX package blocked.  Integer device path: tolerance 0.
"""

import inspect
import json
import threading

import numpy as np
import pytest
import torch

from tests.test_torch_distributed import free_port, run_children
from tests.test_torch_multihost import _batches
from topsicle_tpu_torch.io import batch as batching
from topsicle_tpu_torch.kmers import telophrase_kmers
from topsicle_tpu_torch.models import TorchScanModel
from topsicle_tpu_torch.parallel.multihost import GlobalScanModel


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class _Gated:
    """A local handle whose array exists only once `gate` is set, or that
    raises when `gate` is None."""

    def __init__(self, handle, gate):
        self.handle, self.gate = handle, gate

    def __array__(self, dtype=None, copy=None):
        if self.gate is None:
            raise ValueError("local result failed")
        self.gate.wait()
        a = np.asarray(self.handle)
        return a if dtype is None else a.astype(dtype)


class _GatedModel:
    """A model whose launches hand out _Gated handles."""

    def __init__(self, base, gate):
        self.base, self.gate = base, gate

    def step1_counts_launch(self, ends, lens):
        return _Gated(self.base.step1_counts_launch(ends, lens), self.gate)

    def step2_boundary_launch(self, tails, nw, lens):
        return tuple(_Gated(h, self.gate)
                     for h in self.base.step2_boundary_launch(tails, nw, lens))


def _model():
    return TorchScanModel(telophrase_kmers("CCCTAAA", 7), device="cpu", window_size=100,
                          slide=6)


@pytest.mark.parametrize("step", ["step1", "step2"])
def test_one_process_launch_returns_before_its_result(step):
    """One process: both global launches return while the local result
    is still gated (the launch runs in a thread given 20 s, room for the
    CPU model's own compute on a loaded host); once the gate opens, the
    handles hold the model's own result."""
    model = _model()
    gate = threading.Event()
    g = GlobalScanModel(_GatedModel(model, gate))
    ends, ends_len, tails, lens = _batches(3, 8, False)
    nw = batching.window_counts_for_lengths(lens, 100, 6)
    launch = {"step1": lambda: (g.step1_counts_global_launch(ends, ends_len),),
              "step2": lambda: g.step2_boundary_global_launch(tails, nw, lens)}[step]
    out = []
    th = threading.Thread(target=lambda: out.append(launch()), daemon=True)
    th.start()
    th.join(20.0)
    returned = not th.is_alive()
    gate.set()
    th.join(30.0)
    assert not th.is_alive()
    assert returned, "the global launch waited for its local result"
    want = ((model.step1_counts(ends, ends_len),) if step == "step1"
            else model.step2_boundary(tails, nw, lens))
    assert len(out[0]) == len(want)
    for got, w in zip(out[0], want):
        np.testing.assert_array_equal(np.asarray(got), w)


_HEADER = (
    "import datetime, json, sys, threading, time\n"
    "sys.modules['jax'] = sys.modules['topsicle_tpu'] = None\n"
    "import numpy as np\n"
    "{helpers}\n"
    "from topsicle_tpu_torch.io import batch as batching\n"
    "from topsicle_tpu_torch.kmers import telophrase_kmers\n"
    "from topsicle_tpu_torch.models import TorchScanModel\n"
    "from topsicle_tpu_torch.parallel import mesh, multihost\n"
    "pid = {pid}\n"
    "mesh.COLLECTIVE_TIMEOUT = datetime.timedelta(seconds={timeout})\n"
    "assert mesh.initialize_distributed('127.0.0.1:{port}', 2, pid)\n"
    "model = TorchScanModel(telophrase_kmers('CCCTAAA', 7), device='cpu', window_size=100,\n"
    "                       slide=6)\n"
    "mine = slice(4 * pid, 4 * pid + 4)\n")

# Three batches (the second on the dense wire) launched from a thread
# given 20 s while the local results are gated; then each process drains
# them in its own order.
_ORDER = (
    "gate = threading.Event()\n"
    "g = multihost.GlobalScanModel(_GatedModel(model, gate))\n"
    "handles = []\n"
    "def launch():\n"
    "    for seed in (1, 2, 3):\n"
    "        ends, ends_len, tails, lens = _batches(seed, 8, seed == 2)\n"
    "        nw = batching.window_counts_for_lengths(lens, 100, 6)\n"
    "        dense = seed == 2\n"
    "        handles.append((g.step1_counts_global_launch(ends[mine], ends_len[mine], dense),\n"
    "                        *g.step2_boundary_global_launch(tails[mine], nw[mine],\n"
    "                                                        lens[mine], dense)))\n"
    "th = threading.Thread(target=launch, daemon=True)\n"
    "th.start()\n"
    "th.join(20)\n"
    "out = dict(launched=not th.is_alive(), order={order})\n"
    "gate.set()\n"
    "th.join(120)\n"
    "for i in out['order']:\n"
    "    out[str(i)] = [np.asarray(h).tolist() for h in handles[i]]\n"
    "mesh.shutdown_distributed()\n"
    "out['threads'] = [t.name for t in threading.enumerate()]\n"
    "print(json.dumps(out))\n")


def _helpers():
    return "\n".join(inspect.getsource(o) for o in (_batches, _Gated, _GatedModel))


def test_gathers_follow_launch_order_whatever_the_drain_order():
    """Two gloo processes launch three global batches before any drain;
    process 0 drains them 3, 1, 2 and process 1 drains 1, 2, 3.  Every
    result equals one model's on the whole batch, and the gathers ran
    only after the launches had returned (the local results were gated
    until then)."""
    port = free_port()
    orders = {0: [2, 0, 1], 1: [0, 1, 2]}
    outs = [json.loads(o.strip().splitlines()[-1])
            for o in run_children([(_HEADER + _ORDER).format(
                helpers=_helpers(), pid=p, port=port, timeout=120, order=orders[p])
                for p in (0, 1)])]
    model = _model()
    for pid, out in enumerate(outs):
        assert out["launched"], f"process {pid}: a global launch waited for its result"
        assert out["order"] == orders[pid]
        assert out["threads"] == ["MainThread"], out["threads"]
    for i, seed in enumerate((1, 2, 3)):
        ends, ends_len, tails, lens = _batches(seed, 8, seed == 2)
        nw = batching.window_counts_for_lengths(lens, 100, 6)
        t, has = model.step2_boundary(tails, nw, lens)
        want = [model.step1_counts(ends, ends_len).tolist(), t.tolist(), has.tolist()]
        assert sum(has) > 1
        for out in outs:
            assert out[str(i)] == want, f"batch {i + 1}"


# Process 0's local results raise; both processes read two handles (the
# failed batch and a later one) and say what each raised, and how long
# it took.  With {stay}, process 0 stays alive past the collective
# timeout before it leaves the group.
_FAIL = (
    "gate = None if pid == 0 else threading.Event()\n"
    "if gate is not None:\n"
    "    gate.set()\n"
    "g = multihost.GlobalScanModel(_GatedModel(model, gate))\n"
    "ends, ends_len, _, _ = _batches(4, 8, False)\n"
    "t0 = time.monotonic()\n"
    "handles = [g.step1_counts_global_launch(ends[mine], ends_len[mine]) for _ in range(2)]\n"
    "errors = []\n"
    "for h in handles:\n"
    "    try:\n"
    "        np.asarray(h)\n"
    "        errors.append(None)\n"
    "    except Exception as e:\n"
    "        errors.append(f'{{type(e).__name__}}: {{e}}'[:300])\n"
    "out = dict(errors=errors, seconds=time.monotonic() - t0)\n"
    "if {stay} and pid == 0:\n"
    "    time.sleep({timeout} + 5)\n"
    "mesh.shutdown_distributed()\n"
    "out['threads'] = [t.name for t in threading.enumerate()]\n"
    "print(json.dumps(out))\n")


@pytest.mark.parametrize("stay", [False, True], ids=["peer_leaves", "peer_stays"])
def test_failed_local_result_raises_on_every_process(stay):
    """Process 0's local result raises: its own handle and the later one
    raise that error.  Process 1's gather of the batch fails, as its peer
    never sends: at once when the peer leaves the group, after the
    shortened collective timeout when it stays; the later handle raises
    the same.  Neither hangs, and no thread is left after
    shutdown_distributed."""
    port = free_port()
    timeout = 15
    outs = [json.loads(o.strip().splitlines()[-1])
            for o in run_children([(_HEADER + _FAIL).format(
                helpers=_helpers(), pid=p, port=port, timeout=timeout, stay=stay)
                for p in (0, 1)])]
    assert outs[0]["errors"] == ["ValueError: local result failed"] * 2
    first, later = outs[1]["errors"]
    assert first is not None and later == first
    if stay:
        assert "timed out" in first.lower(), first
    for out in outs:
        assert out["seconds"] < timeout + 10
        assert out["threads"] == ["MainThread"], out["threads"]
