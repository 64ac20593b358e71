"""The kernels' CPython binding (``csrc/bind.cpp``) on the CPU, linked with
a stub C library in place of the kernels.

The binding is built by the host-compiler command of the real build
(``_build.bind_command``: g++ and Python's headers, no torch or CUDA
headers) and linked with a stub that defines every entry of
``_build._SIGNATURES`` with those parameter types and records the
arguments it receives; ``_build.import_binding`` imports the result, once
for the module. Skipped only where g++ or Python.h is missing. The card's
launches through the real library are checked in
test_torch_kernels_cuda.py.
"""

import ctypes
import shutil
import subprocess
import sysconfig
from pathlib import Path

import pytest
import torch

from meshrecon_torch.kernels import _build

ENTRIES = sorted(_build._SIGNATURES)
C_TYPES = {"P": "void*", "I": "int", "F": "float"}
MAX_ARGS = 32
STREAM = 0xFFFF_8000_1234_5670  # above 2**63: no bit may be cut
INTS = (0, -1, 2 ** 31 - 1, -2 ** 31, 7, 12345)


def _stub_source() -> str:
    """C++ for a library that defines every entry: each records its name,
    its argument count, each pointer or int as a long long and each float
    as a double, and returns ``stub_code``."""
    lines = ["#include <stdint.h>", 'extern "C" {',
             f"long long stub_ints[{MAX_ARGS}];",
             f"double stub_floats[{MAX_ARGS}];",
             "const char* stub_name;", "int stub_nargs;", "int stub_code;"]
    for name, kinds in _build._SIGNATURES.items():
        params = ", ".join(f"{C_TYPES[k]} a{i}" for i, k in enumerate(kinds))
        body = [f'stub_name = "{name}";', f"stub_nargs = {len(kinds)};"]
        for i, k in enumerate(kinds):
            body.append(f"stub_floats[{i}] = a{i};" if k == "F" else
                        f"stub_ints[{i}] = (long long)(intptr_t)a{i};")
        lines.append(f"int {name}({params}) {{ {' '.join(body)} "
                     "return stub_code; }")
    lines.append("}")
    return "\n".join(lines)


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"


@pytest.fixture(scope="module")
def bound(tmp_path_factory):
    """(the binding linked with the stub, the same library through ctypes
    to read the stub's records)."""
    include = Path(sysconfig.get_paths()["include"])
    if shutil.which("g++") is None or not (include / "Python.h").exists():
        pytest.skip("needs g++ and Python's headers (Python.h)")
    tmp = tmp_path_factory.mktemp("bind")
    stub = tmp / "stub.cpp"
    stub.write_text(_stub_source())
    bind_o, stub_o, lib = tmp / "bind.o", tmp / "stub.o", tmp / "libstub.so"
    _run(_build.bind_command(bind_o))
    _run(["g++", "-fPIC", "-c", "-o", str(stub_o), str(stub)])
    _run(["g++", "-shared", "-o", str(lib), str(bind_o), str(stub_o)])
    return _build.import_binding(lib), ctypes.CDLL(str(lib))


def _record(cdll, kinds):
    """(entry name, argument count, the arguments) of the last call that
    reached the stub; pointers modulo 2**64."""
    ints = (ctypes.c_longlong * MAX_ARGS).in_dll(cdll, "stub_ints")
    floats = (ctypes.c_double * MAX_ARGS).in_dll(cdll, "stub_floats")
    name = ctypes.c_char_p.in_dll(cdll, "stub_name").value
    got = [floats[i] if k == "F" else ints[i] % 2 ** 64 if k == "P"
           else ints[i] for i, k in enumerate(kinds)]
    return (name and name.decode(),
            ctypes.c_int.in_dll(cdll, "stub_nargs").value, got)


def _arguments(kinds, tensor):
    """(arguments, what the entry should receive): pointers above 2**32,
    the second one None (NULL) and the third ``tensor`` (its data_ptr());
    ints at int32's ends and below zero; floats exact in float32; the
    stream last."""
    args, want = [], []
    for i, k in enumerate(kinds[:-1]):
        if k == "P":
            n = kinds[:i].count("P")
            arg = {1: None, 2: tensor}.get(n, (1 << 40) + 4096 * i)
            exp = {1: 0, 2: tensor.data_ptr()}.get(n, arg)
        elif k == "I":
            arg = exp = INTS[i % len(INTS)]
        else:
            arg = exp = 144.0 + 0.5 * i
        args.append(arg)
        want.append(exp)
    return args + [STREAM], want + [STREAM]


def test_the_binding_has_one_function_an_entry(bound):
    ext, _ = bound
    assert ext.__name__ == _build.BIND_MODULE
    assert sorted(n for n in dir(ext) if n.startswith("mr_")) == ENTRIES
    assert _build.BIND_SOURCE in _build._sources()  # in the library's hash


@pytest.mark.parametrize("entry", ENTRIES)
def test_arguments_arrive_in_order_with_the_stream_last(bound, entry):
    """Each argument at its place with its kind: pointers above 2**32 and
    the stream intact, None as NULL, a tensor as its data_ptr(), ints and
    floats exactly; the entry's return value comes back."""
    ext, cdll = bound
    kinds = _build._SIGNATURES[entry]
    tensor = torch.zeros(4)
    args, want = _arguments(kinds, tensor)
    ctypes.c_int.in_dll(cdll, "stub_code").value = 700 + len(kinds)
    assert getattr(ext, entry)(*args) == 700 + len(kinds)
    assert _record(cdll, kinds) == (entry, len(kinds), want)


@pytest.mark.parametrize("entry", ENTRIES)
def test_a_wrong_count_or_type_raises(bound, entry):
    """One argument too few or too many, a string for a pointer, a float
    for an int, None for a float: TypeError naming the entry (and the
    argument); an int past int32: OverflowError. None reaches the entry."""
    ext, cdll = bound
    fn = getattr(ext, entry)
    kinds = _build._SIGNATURES[entry]
    args, _ = _arguments(kinds, torch.zeros(4))
    ctypes.c_int.in_dll(cdll, "stub_nargs").value = -1
    with pytest.raises(TypeError, match=f"{entry} takes {len(kinds)}"):
        fn(*args[:-1])
    with pytest.raises(TypeError, match=f"{entry} takes {len(kinds)}"):
        fn(*args, STREAM)
    for i, k in enumerate(kinds):
        bad = list(args)
        bad[i] = {"P": "x", "I": 1.5, "F": None}[k]
        with pytest.raises(TypeError, match=f"{entry}: argument {i} "):
            fn(*bad)
        if k == "I":
            bad[i] = 2 ** 31
            with pytest.raises(OverflowError, match=f"{entry}: argument"):
                fn(*bad)
    assert ctypes.c_int.in_dll(cdll, "stub_nargs").value == -1


def _hooks(ext, current=0, capturing=False):
    """Hand the binding's launch its hooks: the current device
    ``current``, the stream STREAM + index, the capture flag."""
    ext.set_launch_hooks(lambda: current, lambda index: STREAM + index,
                         lambda: capturing)


@pytest.mark.parametrize("capturing", [False, True])
def test_launch_on_the_current_device(bound, monkeypatch, capturing):
    """``launch(fn, *args)``: fn on args and the current device's stream,
    then (its status, the capture flag)."""
    ext, cdll = bound
    monkeypatch.setattr(torch.Tensor, "get_device", lambda self: 2)
    _hooks(ext, current=2, capturing=capturing)
    ctypes.c_int.in_dll(cdll, "stub_code").value = 9
    x, out = torch.zeros(8, 128), torch.empty(8, 128)
    assert ext.launch(ext.mr_roofline_tiny, x, out, 8, 1) == (9, capturing)
    assert _record(cdll, "PPIIP") == ("mr_roofline_tiny", 5, [
        x.data_ptr(), out.data_ptr(), 8, 1, STREAM + 2])


@pytest.mark.parametrize("device", [-1, 1])
def test_launch_off_the_current_device_launches_nothing(bound, monkeypatch,
                                                        device):
    """A CPU tensor (-1) or another device: None, and nothing reaches the
    entry; wrong hooks or arguments raise TypeError."""
    ext, cdll = bound
    monkeypatch.setattr(torch.Tensor, "get_device", lambda self: device)
    _hooks(ext, current=0)
    ctypes.c_int.in_dll(cdll, "stub_nargs").value = -1
    x = torch.zeros(8, 128)
    assert ext.launch(ext.mr_roofline_tiny, x, x, 8, 1) is None
    assert ctypes.c_int.in_dll(cdll, "stub_nargs").value == -1
    with pytest.raises(TypeError, match="launch takes"):
        ext.launch(ext.mr_roofline_tiny)
    with pytest.raises(TypeError, match="three callables"):
        ext.set_launch_hooks(lambda: 0, None, lambda: False)


def test_kernel_launch_goes_through_the_binding(bound, monkeypatch):
    """``Kernel.launch`` passes the tensors themselves to the binding's
    launch, which hands the entry their data_ptr()s, the stream last, and
    counts only what ran outside a capture."""
    ext, cdll = bound
    monkeypatch.setattr(_build, "_REGISTRY", [])
    monkeypatch.setattr(_build, "library", lambda: _build.Library(
        cdll, ext, None, 0.0, ""))
    monkeypatch.setattr(torch.Tensor, "get_device", lambda self: 0)
    _hooks(ext)
    ctypes.c_int.in_dll(cdll, "stub_code").value = 0
    k = _build.Kernel("probe", "mr_roofline_tiny", "src", "ref")
    x, out = torch.zeros(8, 128), torch.empty(8, 128)
    k.launch(x, out, 8, 1)
    assert k.launches == 1
    assert _record(cdll, "PPIIP") == ("mr_roofline_tiny", 5, [
        x.data_ptr(), out.data_ptr(), 8, 1, STREAM])
    _hooks(ext, capturing=True)
    k.launch(x, out, 8, 1)
    assert k.launches == 1
