"""``Kernel.launch``'s path on the CPU, with a stub library in place of the
built one: what reaches the C entry, when it raises, and what it counts.

The stub stands in for ``_build.library`` and the three device helpers
(``_current_device``, ``_raw_stream``, ``_capturing``), so no CUDA device
or nvcc is needed; ``torch.Tensor.get_device`` is patched to say device 0.
The card's own launches are checked in test_torch_kernels_cuda.py.
"""

import pytest
import torch

from meshrecon_torch.kernels import _build

STREAM = 0x5EED


class _Entry:
    def __init__(self, code):
        self.code = code
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return self.code


class _CDLL:
    """Entries by name; counts how often each is looked up."""

    def __init__(self, code=0):
        self.lookups = {}
        self.entries = {}
        self.code = code

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        self.lookups[name] = self.lookups.get(name, 0) + 1
        if name == "mr_error_string":
            return lambda code: f"stub error {code}".encode()
        return self.entries.setdefault(name, _Entry(self.code))


@pytest.fixture
def stub(monkeypatch):
    """A fresh registry and a stub library; returns the stub's state (its
    CDLL, the library() calls, the capture flag)."""
    state = {"library": 0, "capturing": False, "cdll": _CDLL()}

    def library():
        state["library"] += 1
        return _build.Library(state["cdll"], None, 0.0, "")

    monkeypatch.setattr(_build, "_REGISTRY", [])
    monkeypatch.setattr(_build, "library", library)
    monkeypatch.setattr(_build, "_current_device", lambda: 0)
    monkeypatch.setattr(_build, "_raw_stream", lambda index: STREAM + index)
    monkeypatch.setattr(_build, "_capturing", lambda: state["capturing"])
    monkeypatch.setattr(torch.Tensor, "get_device", lambda self: 0)
    return state


def test_arguments_reach_the_entry_in_order_with_the_stream_last(stub):
    k = _build.Kernel("probe", "mr_roofline_tiny", "src", "ref")
    x, out = torch.zeros(8, 128), torch.empty(8, 128)
    k.launch(x, out, 8, 1)
    (call,) = stub["cdll"].entries["mr_roofline_tiny"].calls
    assert call == (x.data_ptr(), out.data_ptr(), 8, 1, STREAM)


def test_nonzero_code_raises_with_the_error_text(stub):
    stub["cdll"].code = 700
    k = _build.Kernel("probe", "mr_warp_bilinear", "src", "ref")
    x = torch.zeros(2, 4, 4)
    with pytest.raises(RuntimeError, match="probe.*700.*stub error 700"):
        k.launch(x, x, x, x, 2, 4, 4)
    assert k.launches == 0


def test_a_launch_counts_once_and_the_entry_resolves_once(stub):
    k = _build.Kernel("probe", "mr_roofline_copy", "src", "ref")
    other = _build.Kernel("other", "mr_roofline_copy", "src", "ref")
    x = torch.zeros(16)
    for _ in range(3):
        k.launch(x, x, 16)
    assert (k.launches, other.launches) == (3, 0)
    assert stub["library"] == 1
    assert stub["cdll"].lookups == {"mr_roofline_copy": 1}
    assert _build.all_kernels() == [k, other]


def test_a_launch_under_capture_is_not_counted(stub):
    k = _build.Kernel("probe", "mr_roofline_copy", "src", "ref")
    x = torch.zeros(16)
    stub["capturing"] = True
    k.launch(x, x, 16)
    assert k.launches == 0
    assert len(stub["cdll"].entries["mr_roofline_copy"].calls) == 1
    stub["capturing"] = False
    k.launch(x, x, 16)
    assert k.launches == 1


def test_a_cpu_first_argument_is_refused(stub, monkeypatch):
    monkeypatch.setattr(torch.Tensor, "get_device", lambda self: -1)
    k = _build.Kernel("probe", "mr_roofline_copy", "src", "ref")
    x = torch.zeros(16)
    with pytest.raises(ValueError, match="probe"):
        k.launch(x, x, 16)
    assert k.launches == 0
    assert not stub["cdll"].entries["mr_roofline_copy"].calls


def test_unknown_entry_is_refused():
    with pytest.raises(ValueError, match="unknown entry"):
        _build.Kernel("probe", "mr_no_such_entry", "src", "ref")


def test_checks_refuse_cpu_tensors_and_mismatched_shapes(monkeypatch):
    x = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="argument 0 on cpu"):
        _build.check_cuda("f", x)
    with pytest.raises(ValueError, match="argument 0 on cpu"):
        _build.check_like("f", x, x)
    # as if on device 0: the shapes are held to the first tensor's
    monkeypatch.setattr(torch.Tensor, "get_device", lambda self: 0)
    _build.check_like("f", x, x.clone())
    with pytest.raises(ValueError, match=r"argument 1 has shape \(3, 2\)"):
        _build.check_like("f", x, x.t())
