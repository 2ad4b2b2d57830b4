"""The port's one launch path (``native.Library``) on the CPU, with fakes in
place of the card: each wrapper's checks raise before any build, each
library's bound argument types match its C entry points, and
``Library.launch`` passes the current stream last, enters a device guard only
for another device than the current one, and raises on a non-zero return."""
import ctypes
import re

import pytest
import torch

from torchregister_tpu_torch import native
from torchregister_tpu_torch.ops.cuda import conv3d as k3
from torchregister_tpu_torch.ops.cuda import roigather as k2b
from torchregister_tpu_torch.ops.cuda import splat as ksplat
from torchregister_tpu_torch.ops.cuda import sweep as k1
from torchregister_tpu_torch.ops.cuda import warp as k2
from torchregister_tpu_torch.probes import hatgather as hg
from torchregister_tpu_torch.probes import roi_stages as rs

MODULES = {"sweep": k1, "warp": k2, "conv3d": k3, "roigather": k2b, "hatgather": hg,
           "roi_fetch": rs, "splat": ksplat}


def _c_params(source: str, name: str) -> list:
    """The parameter types of ``extern "C" ... name(...)`` in ``source``."""
    m = re.search(r'extern "C" [\w ]+ ' + name + r'\(([^)]*)\)', source)
    assert m, f"{name} is not exported"
    return [" ".join(p.split()[:-1]) for p in m.group(1).split(",")]


def _ctype(c_type: str):
    if "*" in c_type:
        return ctypes.c_void_p
    return {"int": ctypes.c_int, "long long": ctypes.c_longlong}[c_type.replace("const ", "")]


@pytest.mark.parametrize("module", sorted(MODULES))
def test_torch_launch_argtypes_match_the_c_entry_points(module):
    """Every bound entry point has the C function's arity and types (a
    pointer as ``c_void_p``, never a 32-bit int), and every source's entry
    points are bound."""
    lib = MODULES[module].LIB
    source = lib.source.read_text()
    exported = set(re.findall(r'extern "C" [\w ]+? (\w+)\(', source))
    assert exported == set(lib.entries)
    for name, (restype, argtypes) in lib.entries.items():
        assert argtypes == [_ctype(t) for t in _c_params(source, name)], name
        assert restype in (ctypes.c_int, ctypes.c_longlong)


def test_torch_launch_hatgather_exports_its_four_kernels():
    source = hg.LIB.source.read_text()
    for name in hg.KERNELS:
        assert f'extern "C" int {name}(' in source
    assert set(hg.KERNELS) < set(hg.LIB.entries)


def _no_build(monkeypatch, lib):
    def fail():
        raise AssertionError("the library was built before the inputs were checked")

    monkeypatch.setattr(lib, "build", fail)
    monkeypatch.setattr(lib, "_fns", None)


def _probe_launch(name, vol, idx):
    if name == "slab_gather":
        return hg.slab_gather_launch(vol, idx, 14, 16)
    if name == "slab_sum":
        return hg.slab_sum_launch(vol, idx, 14, 16)
    if name == "slice_transpose":
        return hg.slice_transpose_launch(vol, idx, 14, 16, 16, 256)
    if name == "block_permute_add":
        return hg.block_permute_add_launch(vol[0], idx[:, 0].contiguous())
    return rs.roi_fetch_launch(vol, idx)


@pytest.mark.parametrize("name", [*hg.KERNELS, "roi_fetch"])
@pytest.mark.parametrize("case", ["cpu", "volume_dtype", "index_dtype", "non_contiguous"])
def test_torch_launch_checks_raise_before_any_build(name, case, monkeypatch):
    """A probe kernel's launch checks its operands before the library is
    built: dtypes (TypeError), then contiguity, then the CUDA device."""
    _no_build(monkeypatch, hg.LIB)
    _no_build(monkeypatch, rs.LIB)
    vol = torch.zeros((32, 32, 256))
    idx = torch.zeros((3, 5 if name == "roi_fetch" else 3), dtype=torch.int32)
    err, match = ValueError, "one CUDA device"
    if case == "volume_dtype":
        vol, err, match = vol.double(), TypeError, "float32"
    elif case == "index_dtype":
        idx, err, match = idx.long(), TypeError, "int32"
    elif case == "non_contiguous":
        vol, match = vol.transpose(0, 1), "contiguous"
    with pytest.raises(err, match=match):
        _probe_launch(name, vol, idx)


def test_torch_launch_check_operands_order():
    f32, i32 = torch.float32, torch.int32
    a, b = torch.zeros(4), torch.zeros(4, dtype=i32)
    with pytest.raises(TypeError, match="int32"):
        native.check_operands("k", (a, f32), (b.long(), i32))
    with pytest.raises(ValueError, match="contiguous"):
        native.check_operands("k", (torch.zeros((4, 4)).T, f32), (b, i32))
    with pytest.raises(ValueError, match="one CUDA device"):
        native.check_operands("k", (a, f32), (b, i32))


class _FakeFn:
    def __init__(self, rc=0):
        self.calls, self.rc = [], rc

    def __call__(self, *args):
        self.calls.append(args)
        return self.rc


class _FakeTensor:
    def __init__(self, index):
        self.index = index

    def get_device(self):
        return self.index


@pytest.fixture
def fake_card(monkeypatch):
    """A Library bound to a fake entry point, on a fake card whose current
    device is 0; records the device guards entered and the streams read."""
    lib = native.Library(hg.SOURCE, "fake", {"k": (ctypes.c_int, [ctypes.c_int])})
    fn = _FakeFn()
    lib._fns = {"k": fn}
    guards, streams = [], []

    class Guard:
        def __init__(self, index):
            guards.append(index)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    def raw_stream(index):
        streams.append(index)
        return 1000 + index

    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0, raising=False)
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", raw_stream, raising=False)
    return lib, fn, guards, streams


def test_torch_launch_current_device_takes_no_guard(fake_card):
    lib, fn, guards, streams = fake_card
    lib.launch("k", _FakeTensor(0), 7)
    lib.launch("k", _FakeTensor(0), 8)
    assert fn.calls == [(7, 1000), (8, 1000)]
    assert guards == [] and streams == [0, 0]  # the stream read on every launch


def test_torch_launch_other_device_takes_its_guard_and_stream(fake_card):
    lib, fn, guards, streams = fake_card
    lib.launch("k", _FakeTensor(1), 7)
    assert fn.calls == [(7, 1001)] and guards == [1] and streams == [1]


def test_torch_launch_raises_on_a_cuda_error(fake_card):
    lib, fn, _, _ = fake_card
    fn.rc = 9
    with pytest.raises(RuntimeError, match="k launch failed: cudaError 9"):
        lib.launch("k", _FakeTensor(0), 7)


def test_torch_launch_binds_each_entry_once(monkeypatch, tmp_path):
    """``fns`` loads the library and sets each entry's argtypes and restype
    once; later calls reuse them."""
    loads = []

    class FakeCDLL:
        def __init__(self, path):
            loads.append(path)
            self.k = _FakeFn()

    monkeypatch.setattr(ctypes, "CDLL", FakeCDLL)
    lib = native.Library(hg.SOURCE, "fake", {"k": (ctypes.c_int, (ctypes.c_void_p,
                                                                  ctypes.c_int))})
    monkeypatch.setattr(lib, "build", lambda: tmp_path / "fake.so")
    fns = lib.fns()
    assert lib.fns() is fns and loads == [str(tmp_path / "fake.so")]
    assert fns["k"].argtypes == [ctypes.c_void_p, ctypes.c_int]
    assert fns["k"].restype is ctypes.c_int


_PTXAS = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118slab_gather_kernelI6float4Li4EEEvPKT_PKiPS2_iiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118slab_gather_kernelI6float4Li4EEEvPKT_PKiPS2_iiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 16 registers, used 0 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115slab_sum_kernelEPKfPKiPfiiiiii' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, used 0 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122slice_transpose_kernelILb1EEEvPKfPKiPfiiiiiii' for 'sm_90a'
    0 bytes stack frame, 20 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers, 408 bytes cmem[0]
"""


def test_torch_profile_copies_reads_the_copies_resources():
    """The A/B script keeps the two copies' register and spill counts from
    ptxas's report and drops every other kernel's."""
    from torchregister_tpu_torch.probes import profile_copies as pc

    got = pc.resources(_PTXAS)
    assert list(got.values()) == ["16 registers, 0 bytes spill", "32 registers, 20 bytes spill"]
    assert all("slab_sum" not in name for name in got)


def test_torch_profile_copies_cases_match_the_smoke_probes():
    """The A/B script's cases are ``chip_smoke.py``'s copies: the probes'
    origins and the device-bound counts, every index in range."""
    from torchregister_tpu_torch.probes import profile_copies as pc

    cases = pc.cases(torch.device("cpu"))
    counts = {case: args[1].shape[0] for case, (_, args) in cases.items()}
    assert counts == {"slab_gather": 6, "slab_gather_p4": 5, "slice_transpose": 4,
                      "slab_gather_big": pc.BIG_SLABS, "slice_transpose_big": pc.BIG_STARTS}
    vol, orgs, Bz, By = cases["slab_gather_big"][1]
    assert torch.equal(orgs, torch.from_numpy(hg.p3_origins(240, pc.BIG_SLABS)))
    assert int(orgs[:, 0].max()) <= vol.shape[0] - Bz and int(orgs[:, 1].max()) <= vol.shape[1] - By
    slab, starts, Bz, By, CW, lanes = cases["slice_transpose"][1]
    out = hg.slice_transpose_plain(slab, starts, Bz, By, CW, lanes)
    assert out.shape == (4, CW, lanes) and torch.equal(out[0, :, 0], slab[0, 0, 3:3 + CW])
