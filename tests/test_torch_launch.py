"""``Kernel.launch``'s path on the CPU, with a stub library in place of the
built one: what reaches the binding's function, when it raises, and what
it counts.

The stub stands in for ``_build.library`` (its extension module's launch
functions, and ctypes' ``mr_error_string``) and the three device helpers
(``_current_device``, ``_raw_stream``, ``_capturing``), so no CUDA device,
nvcc or g++ is needed; ``torch.Tensor.get_device`` is patched to say
device 0. test_torch_bind.py holds the binding itself against a stub C
library; the card's own launches are checked in
test_torch_kernels_cuda.py.
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


class _Binding:
    """The extension module's entry functions by name (counting how often
    each is looked up), and its ``launch`` by the C function's contract
    (test_torch_bind.py holds the C function to it)."""

    def __init__(self, code=0):
        self.lookups = {}
        self.entries = {}
        self.code = code

    @staticmethod
    def launch(fn, *args):
        """(status, capturing) on the current device, else None."""
        index = args[0].get_device()
        if index < 0 or index != _build._current_device():
            return None
        return fn(*args, _build._raw_stream(index)), _build._capturing()

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        self.lookups[name] = self.lookups.get(name, 0) + 1
        return self.entries.setdefault(name, _Entry(self.code))


class _CDLL:
    """ctypes' side of the library: the error text only."""

    def mr_error_string(self, code):
        return f"stub error {code}".encode()


@pytest.fixture
def stub(monkeypatch):
    """A fresh registry and a stub library; returns the stub's state (its
    binding, the library() calls, the capture flag)."""
    state = {"library": 0, "capturing": False, "ext": _Binding()}

    def library():
        state["library"] += 1
        return _build.Library(_CDLL(), state["ext"], None, 0.0, "")

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
    (call,) = stub["ext"].entries["mr_roofline_tiny"].calls
    # the tensors themselves: the binding reads their data_ptr()
    assert call[0] is x and call[1] is out
    assert call[2:] == (8, 1, STREAM)


def test_nonzero_code_raises_with_the_error_text(stub):
    stub["ext"].code = 700
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
    assert stub["ext"].lookups == {"mr_roofline_copy": 1}
    assert _build.all_kernels() == [k, other]


def test_launches_from_threads_count_exactly(stub, monkeypatch):
    """Shards launch from threads of their own (sharding/meshes.py): no
    increment is lost, even with the interpreter switching threads every
    microsecond."""
    import sys
    import threading

    monkeypatch.setattr(sys, "getswitchinterval", sys.getswitchinterval)
    sys.setswitchinterval(1e-6)
    k = _build.Kernel("probe", "mr_roofline_copy", "src", "ref")
    x = torch.zeros(16)
    start = threading.Barrier(8)

    def shard():
        start.wait()
        for _ in range(2000):
            k.launch(x, x, 16)

    threads = [threading.Thread(target=shard) for _ in range(8)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    finally:
        sys.setswitchinterval(0.005)
    assert k.launches == 8 * 2000


def test_a_launch_under_capture_is_not_counted(stub):
    k = _build.Kernel("probe", "mr_roofline_copy", "src", "ref")
    x = torch.zeros(16)
    stub["capturing"] = True
    k.launch(x, x, 16)
    assert k.launches == 0
    assert len(stub["ext"].entries["mr_roofline_copy"].calls) == 1
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
    assert not stub["ext"].entries["mr_roofline_copy"].calls


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
