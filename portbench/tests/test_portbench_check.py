"""The check that decides `correct`, shown to fail.

Each cell's limits are its real cell's (the small cells keep them). A run
of the port passes them; the control, the reference in the program's place
computed in the precision below the configuration's (sampling bf16 -> fp8,
training fp32 -> TF32), fails one of a cell's numbers; and a whole run of
the harness (without its look for a card) with the timed path broken
underneath comes out `correct: false` for every fault the cell can have
(`harness.faults`); the control too is a whole run, with the mode's
`Control` in the program's place. On the CPU at a small size; the `cuda`
tests drive the same on the card at that size (at the cells' own sizes,
`portbench/calibrate.py --kinds control,...` on the card)."""

import time

import pytest
import torch

import pbtest_tiny
from portbench.harness import cell, discovery, faults

CELLS = {"tiny-sample": faults.SAMPLE, "tiny-train": faults.TRAIN,
         "tiny-train-loader": ("half_batch",)}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return pbtest_tiny.tiny_root(tmp_path_factory.mktemp("pb"))


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda"


def _run(root, name, device, system=None):
    return cell.run_cell(name, pbtest_tiny.SEED, 0.2, False, device, time.perf_counter(),
                         root=root, system=system)


def _faulty(root, name, fault):
    wl = discovery.load_workload(name, root)
    mode = discovery.load_mode(wl["mode"], root)
    return (faults.sample_port if wl["mode"] == "sample" else faults.train_port)(mode, fault)


def _control(root, name, device):
    """A run with the control, the reference with its precision lowered, in
    the program's place."""
    wl = discovery.load_workload(name, root)
    return _run(root, name, device, discovery.load_mode(wl["mode"], root).Control)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_the_port_passes(root, name):
    out = _run(root, name, "cpu")
    assert out["correct"] is True, out["checks"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name", ["tiny-sample", "tiny-train"])
def test_the_control_fails(root, name):
    out = _control(root, name, "cpu")
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("name,fault", [(n, f) for n, fs in sorted(CELLS.items()) for f in fs])
def test_a_fault_makes_the_run_incorrect(root, name, fault):
    out = _run(root, name, "cpu", _faulty(root, name, fault))
    assert out["correct"] is False, (fault, out["checks"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CELLS))
def test_on_the_card(root, cuda, name):
    out = _run(root, name, cuda)
    assert out["correct"] is True, out["checks"]
    assert out["device"]["kind"] == torch.cuda.get_device_name(0)
    for fault in CELLS[name]:
        bad = _run(root, name, cuda, _faulty(root, name, fault))
        assert bad["correct"] is False, (fault, bad["checks"])
    if name != "tiny-train-loader":
        out = _control(root, name, cuda)
        assert out["correct"] is False, out["checks"]
