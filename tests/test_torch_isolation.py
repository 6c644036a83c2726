"""The port stands alone and never falls back: no JAX or mvapich2_tpu
import in mvapich2_tpu_torch/ or chip_smoke.py, no quiet CPU run when a
CUDA device was asked for, no plain-PyTorch stand-in for a kernel on a
non-CPU tensor, and ctypes bindings that declare every pointer and the
stream as c_void_p."""

import ast
import ctypes
import os
import re

import numpy as np
import pytest
import torch

import mvapich2_tpu_torch
from mvapich2_tpu_torch.ops import _build, hbm
from mvapich2_tpu_torch.utils import config, detect, timing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "mvapich2_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "mvapich2_tpu"}


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "__import__", "import_module") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_import(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert bad == [], f"{os.path.relpath(path, REPO)} imports {bad}"


def test_dynamic_process_modules_are_scanned():
    """The spawn, port, name-service and intercomm modules and their
    programs are among the files the import scan reads."""
    scanned = {os.path.relpath(p, PKG) for p in _port_sources()}
    for rel in ("core/intercomm.py", "coll/inter.py", "coll/nbc/inter.py",
                "runtime/spawn.py", "runtime/nameserv.py",
                "progs/spawn_parent.py", "progs/spawn_child.py"):
        assert rel in scanned, rel


def test_topology_attribute_info_modules_are_scanned():
    """The topology, attribute-cache and Info modules are among the files
    the import scan reads."""
    scanned = {os.path.relpath(p, PKG) for p in _port_sources()}
    for rel in ("core/topo.py", "core/attr.py", "core/info.py"):
        assert rel in scanned, rel


def test_window_and_io_modules_are_scanned():
    """The host-window and MPI-IO modules are among the files the import
    scan reads."""
    scanned = {os.path.relpath(p, PKG) for p in _port_sources()}
    for rel in ("rma/win.py", "io/adio.py", "io/view.py", "io/file.py"):
        assert rel in scanned, rel


def test_scanner_matches_module_names_exactly(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import mvapich2_tpu_torch\nfrom mvapich2_tpu_torch.ops "
                 "import hbm\nimport jax.numpy as jnp\n"
                 "from mvapich2_tpu.core import op\n")
    assert sorted(set(_imported_roots(str(p))) & FORBIDDEN) == \
        ["jax", "mvapich2_tpu"]


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_run_ranks_without_device_raises_off_card(monkeypatch):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mvapich2_tpu_torch.run_ranks(2, lambda comm: None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mvapich2_tpu_torch.local_universe(2, device="cuda:0")


def test_kernel_request_raises_off_card(monkeypatch):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _build.load("hbm_slot")
    # a tensor that is not on the CPU never takes the plain route
    x = torch.empty((2, 4, 128), device="meta")
    before = dict(hbm.PLAIN_CALLS)
    with pytest.raises(ValueError, match="CUDA tensors"):
        hbm.fused_reduce_to_slot(x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        hbm.fused_allreduce(torch.empty((4, 2, 128), device="meta"))
    assert hbm.PLAIN_CALLS == before


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("hbm_slot")


def test_build_raises_on_wrong_arch(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda d=None: (8, 0))
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA A100")
    with pytest.raises(RuntimeError, match="sm_90a"):
        _build.check_device()


def test_kernel_dtype_table_rejects_unsupported():
    from mvapich2_tpu_torch.ops import ring
    for dt in (torch.float64, torch.int64, torch.bool):
        assert dt not in hbm._DTYPE_CODES
        assert dt not in ring.DTYPE_CODES
    # uint16 and uint32 run on the device, as in the JAX package; both
    # tables and both sources' enums agree on their codes
    assert hbm._DTYPE_CODES == ring.DTYPE_CODES
    assert (ring.DTYPE_CODES[torch.uint16],
            ring.DTYPE_CODES[torch.uint32]) == (7, 8)
    for name in ("hbm_slot", "ring"):
        src = (_build.CSRC_DIR / f"{name}.cu").read_text()
        assert "U16 = 7, U32 = 8 };" in src, name


_CTYPE_OF = {"int": ctypes.c_int, "long long": ctypes.c_int64,
             "unsigned long long": ctypes.c_uint64, "float": ctypes.c_float}


def _c_signatures(src):
    """{name: (return type, [(param name, ctype)])} of the extern "C"
    entry points of a .cu source."""
    body = src[src.index('extern "C" {'):]
    out = {}
    for ret, name, params in re.findall(
            r"^(int|const char\*) (mv2t_\w+)\(([^)]*)\)", body, re.M):
        args = []
        for p in " ".join(params.split()).split(","):
            p = p.strip()
            pname = re.findall(r"\w+$", p)[0]
            ctype = p[:-len(pname)].strip()
            args.append((pname, ctypes.c_void_p if "*" in ctype
                         else _CTYPE_OF[ctype]))
        out[name] = (ctypes.c_char_p if "char" in ret else ctypes.c_int,
                     args)
    return out


@pytest.mark.parametrize("lib", sorted(_build.SIGNATURES))
def test_ctypes_signatures_match_sources(lib):
    src = open(os.path.join(PKG, "csrc", f"{lib}.cu")).read()
    want = _c_signatures(src)
    table = _build.SIGNATURES[lib]
    assert sorted(want) == sorted(table)
    for fn, (restype, args) in table.items():
        wret, wargs = want[fn]
        assert restype is wret, fn
        assert [n for n, _ in args] == [n for n, _ in wargs], fn
        for (n, t), (_, wt) in zip(args, wargs):
            assert t is wt, f"{fn}({n}): {t} != {wt}"
        for n, t in args:
            if n in ("x", "out", "stream"):
                assert t is ctypes.c_void_p, f"{fn}({n})"


def test_timing_needs_a_card(monkeypatch):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        timing.time_ms(lambda: None)


@pytest.mark.parametrize("name,gbps", [
    ("NVIDIA H100 80GB HBM3", 3350.0), ("NVIDIA H100 PCIe", 2000.0),
    ("NVIDIA H100 NVL", 3900.0), ("NVIDIA A100-SXM4-80GB", 0.0)])
def test_hbm_bandwidth_table(name, gbps):
    assert detect.lookup_hbm_gbps(name) == gbps


def test_detect_off_card(monkeypatch):
    _no_cuda(monkeypatch)
    info = detect.detect()
    assert info.platform == "cpu" and info.hbm_bw_gbps == 0.0
    assert detect.arch_key() == "cpu:cpu:0"


def test_config_reads_the_reference_env_names(monkeypatch):
    cfg = config.Config({"USE_DEVICE_COLL": True, "ALLREDUCE_ALGO": ""})
    monkeypatch.setenv("MV2T_USE_DEVICE_COLL", "0")
    monkeypatch.setenv("MV2T_ALLREDUCE_ALGO", "device")
    assert cfg["USE_DEVICE_COLL"] is False
    assert cfg.get("ALLREDUCE_ALGO") == "device"
    cfg.set("ALLREDUCE_ALGO", "")
    assert cfg["ALLREDUCE_ALGO"] == ""
    assert cfg.get("NO_SUCH", 7) == 7
    # only the knobs the JAX package declares: no new MV2T_* name
    assert set(config.get_config()._defaults) == {
        "USE_DEVICE_COLL", *(f"{c}_ALGO" for c in config.ALGO_CVARS),
        *config.HOST_CVARS, *config.DEVICE_CVARS, *config.TRACE_CVARS,
        *config.PROCESS_CVARS}
    assert set(config.PROCESS_CVARS) == {
        "STARTUP_TIMING", "USE_CMA", "ARENA_BYTES", "RNDV_CHUNK",
        "RNDV_DEPTH"}
    assert set(config.HOST_CVARS) == {
        "EAGER_THRESHOLD", "SMP_EAGERSIZE", "RNDV_PROTOCOL",
        "R3_CHUNK_SIZE", "USE_TWO_LEVEL"}
    assert set(config.TRACE_CVARS) == {
        "TRACE", "TRACE_BUF", "TRACE_DIR", "METRICS", "JAX_PROFILE"}
    assert set(config.DEVICE_CVARS) == {
        "ICI_CHUNK_BYTES", "ICI_PIPELINE_DEPTH", "ICI_BIDIR",
        "DEV_TIER_VMEM_MAX", "DEV_TIER_XLA_MIN", "DEV_TIER_QUANT_MIN",
        "DEV_TIER_AXES_MIN", "QUANT_COLL", "RMA_CHUNK_BYTES", "DEV_RMA_RDMA_MIN",
        "DEV_RMA_QUANT_MIN", "QUANT_BLOCK", "DEVICE_COLL_MIN_BYTES",
        "DEVICE_NBC_SEG_BYTES", "DEVICE_NBC_MAX_SEGS"}
    # size suffixes and a reload, as in the JAX package
    cfg = config.Config({"ICI_CHUNK_BYTES": 1, "ICI_BIDIR": True})
    monkeypatch.setenv("MV2T_ICI_CHUNK_BYTES", "64K")
    assert cfg["ICI_CHUNK_BYTES"] == 65536
    monkeypatch.setenv("MV2T_ICI_CHUNK_BYTES", "2M")
    assert cfg["ICI_CHUNK_BYTES"] == 65536      # cached until reload
    cfg.reload()
    assert cfg["ICI_CHUNK_BYTES"] == 2 << 20


def test_carry_roundtrip():
    from mvapich2_tpu_torch import carry
    bufs = np.random.default_rng(0).normal(size=(3, 256)).astype(np.float32)
    for layout in ("rows", "planar", "interleaved"):
        t = carry.slots_from_numpy(bufs, layout, "cpu")
        back = carry.to_numpy(t)
        if layout == "interleaved":
            back = carry.to_numpy(hbm.unpack_interleaved(t))
        np.testing.assert_array_equal(back.reshape(3, 256), bufs)
    with pytest.raises(ValueError):
        carry.slots_from_numpy(bufs[:, :100], "planar")
    # uint16, uint32 and int32 (the quant tier's wire words) cross bit
    # for bit, both ways
    rng = np.random.default_rng(1)
    for dt in (np.uint16, np.uint32, np.int32):
        info = np.iinfo(dt)
        rows = rng.integers(info.min, info.max, size=(3, 33),
                            endpoint=True).astype(dt)
        t = carry.window_from_numpy(rows)
        assert t.dtype == getattr(torch, np.dtype(dt).name)
        back = carry.to_numpy(t)
        assert back.dtype == dt
        np.testing.assert_array_equal(back, rows)
