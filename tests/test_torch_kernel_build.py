"""The port's kernel build bookkeeping (ray_tpu_torch._kernels), without nvcc.

A library is named by a hash of its source, every header under ``csrc/`` and
the compiler flags, so an edit to any of them rebuilds instead of loading a
stale library; and every C entry point is called through ctypes with
argument types that match its C signature (an undeclared pointer or stream
would be cut to 32 bits).
"""

import ctypes
import re
import shutil

import pytest

from ray_tpu_torch import _kernels

# C parameter type -> ctypes type of the declared argtypes
_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int, "long long": ctypes.c_longlong,
            "float": ctypes.c_float}


def _c_signature(source: str, fn: str) -> list:
    """The ctypes types of ``fn``'s parameters, read from its definition in
    the ``extern "C"`` block of ``source``."""
    block = source[source.index('extern "C" {'):]
    match = re.search(rf"\bint {fn}\(([^)]*)\)", block)
    assert match, f"{fn} not defined in the extern \"C\" block"
    types = []
    for param in match.group(1).split(","):
        words = param.split()
        ctype = " ".join(words[:-1]).replace(" *", "*")
        if words[-1].startswith("*"):
            ctype += "*"
        types.append(_C_TYPES[ctype])
    return types


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """A copy of csrc/ that lib_path hashes instead of the package's."""
    copy = tmp_path / "csrc"
    shutil.copytree(_kernels.CSRC, copy)
    monkeypatch.setattr(_kernels, "CSRC", copy)
    return copy


def test_headers_are_every_cuh_under_csrc():
    assert set(_kernels.HEADERS) == {p.name for p in
                                     _kernels.CSRC.glob("*.cuh")}
    assert "hopper.cuh" in _kernels.HEADERS


def test_every_source_has_its_file():
    assert {p.stem for p in _kernels.CSRC.glob("*.cu")} == set(
        _kernels.SOURCES)


@pytest.mark.parametrize("name", sorted(_kernels.SOURCES))
@pytest.mark.parametrize("edited", ["source"] + list(_kernels.HEADERS))
def test_lib_path_follows_every_input(csrc_copy, name, edited):
    before = _kernels.lib_path(name)
    assert before == _kernels.lib_path(name)   # deterministic
    path = csrc_copy / (f"{name}.cu" if edited == "source" else edited)
    path.write_bytes(path.read_bytes() + b"\n// edited\n")
    after = _kernels.lib_path(name)
    assert after != before
    assert after.parent == before.parent == _kernels.BUILD_DIR
    assert after.name.startswith(f"lib{name}-") and after.suffix == ".so"


def test_lib_path_follows_the_flags(monkeypatch):
    before = {name: _kernels.lib_path(name) for name in _kernels.SOURCES}
    monkeypatch.setattr(_kernels, "NVCC_FLAGS",
                        _kernels.NVCC_FLAGS + ["-lineinfo"])
    for name, path in before.items():
        assert _kernels.lib_path(name) != path


def test_flags_target_sm90a():
    """wgmma and setmaxnreg exist only for sm_90a; a link flag, had the
    libraries one, would sit here to enter the hash."""
    assert "arch=compute_90a,code=sm_90a" in _kernels.NVCC_FLAGS


@pytest.mark.parametrize("name,fn", [(name, fn) for name, fns in
                                     sorted(_kernels.SOURCES.items())
                                     for fn in sorted(fns)])
def test_entry_point_argtypes_match_c_signature(name, fn):
    """Pointers and the stream are c_void_p, and every other argument has
    its C type, in order."""
    declared = _kernels.SOURCES[name][fn]
    want = _c_signature(_kernels.source(name).read_text(), fn)
    assert declared == want
    # the stream is the last parameter, a pointer
    assert declared[-1] is ctypes.c_void_p


def test_check_names_the_failure():
    _kernels.check(0, "k")
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        _kernels.check(700, "k")
    with pytest.raises(RuntimeError, match="tensor map encode.*CUresult 1"):
        _kernels.check(_kernels.TENSOR_MAP_ERROR + 1, "k")


def test_kernel_operand_copies_what_tma_cannot_read():
    """The kernels read operands through strides, and TMA's tensor maps
    need every stride a multiple of 16 bytes and none 0 across an extent
    above 1: such an operand is passed as it is, any other copied."""
    import torch

    from ray_tpu_torch.ops.flash_attention import _kernel_operand

    x = torch.zeros(2, 16, 4, 64, dtype=torch.bfloat16)    # [b, s, h, d]
    view = x.transpose(1, 2)                                # [b, h, s, d]
    assert _kernel_operand(view) is view
    one_head = x[:, :, :1].transpose(1, 2)    # extent 1: its stride is free
    assert _kernel_operand(one_head) is one_head
    broadcast = x[:, :, :1].expand(2, 16, 4, 64).transpose(1, 2)
    odd = torch.zeros(2, 4, 16, 72, dtype=torch.bfloat16)[..., :64]
    unaligned_stride = torch.zeros(2, 4, 16, 68, dtype=torch.bfloat16)
    unaligned_base = torch.zeros(2, 4, 16, 72, dtype=torch.bfloat16)
    for bad in (broadcast, unaligned_stride[..., :64],
                unaligned_base[..., 1:65]):
        got = _kernel_operand(bad)
        assert got is not bad and got.is_contiguous()
        assert torch.equal(got, bad)
    assert _kernel_operand(odd) is odd     # a 144-byte row stride is fine
