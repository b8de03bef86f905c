"""chip_smoke.py's kernel phases 3c-3d and its SSM/hybrid phases 10-11,
rehearsed on the CPU at toy size.

As in tests/test_torch_chip_smoke.py: the script refuses to run without a
card, so its phases take a device and the reduced configs, and their
control flow (kernel vs plain, bounds, launch gates, paged tokens equal to
dense tokens, the logits gates) is exercised here first.  Timings are
stubbed: CUDA events exist only on the card; the CPU path launches
nothing, so each wrapper's calls are counted as launches.
"""
import re
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from repro_torch.kernels.decode_attention import ops  # noqa: E402
from repro_torch.kernels import ssd as ssd_pkg  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.models import attention, mamba2  # noqa: E402
from torch_parity import one_thread  # noqa: E402,F401 (a fixture)


def _counted(name, module=ops, ref_name=None):
    """Count a CPU call of ``module.name`` as a launch of its kernel."""
    op = getattr(module, name)
    ref = getattr(module, ref_name or f"{name}_ref")

    def call(*args):
        op.launches += 1
        return ref(*args)
    return call


def _counted_ssd(path_of=chip_smoke.ssd_path):
    """Count a CPU scan as a launch on the path the card's entry point
    takes for its inputs (``path_of(x, B, C)``)."""
    def call(x, dt, a_neg, b_mat, c_mat, chunk):
        ssd_ops.ssd_scan.launches += 1
        ssd_ops.ssd_scan.launches_by_path[path_of(x, b_mat, c_mat)] += 1
        return ssd_ops.ssd_chunked(x, dt, a_neg, b_mat, c_mat, chunk)
    return call


@pytest.fixture
def kernels_patched():
    """CUDA timing stubbed; the phases log into the returned list."""
    lines = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(chip_smoke, "log", lines.append)
        mp.setattr(torch.cuda, "synchronize", lambda *a: None)
        mp.setattr(chip_smoke, "time_ms", lambda fn, sets: 0.0)
        mp.setattr(chip_smoke, "eager_ms", lambda fn, sets: 0.0)
        yield lines


def test_flash_kernel_phase_runs_on_cpu(kernels_patched):
    """Phase 3c at small shapes: kernel (here the plain path) vs plain,
    and SDPA agrees with both in f32."""
    chip_smoke.phase_flash_kernels(torch, device="cpu", shapes={
        "gqa7": (14, 2, 64), "mha112": (4, 4, 112)}, lengths=(8, 40))
    assert len(kernels_patched) == 8
    for line in kernels_patched:
        assert "max_abs_err=0 " in line
        if "float32" in line:
            assert float(re.search(r"sdpa err ([0-9.e+-]+)", line)[1]) < 1e-5


PTXAS_LOG = """ptxas info    : Compiling entry function '_Z2tc18flash_wgmma_kernelILi128EE' for 'sm_90a'
ptxas info    : Function properties for _Z2tc18flash_wgmma_kernelILi128EE
    0 bytes stack frame, {spill} bytes spill stores, 0 bytes spill loads
ptxas info    : Used 134 registers, used 1 barriers, 64 bytes smem
ptxas info    : Compiling entry function '_Z22flash_attention_kernelIfLi32EE' for 'sm_90a'
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 48 registers, used 1 barriers
"""
# the gmm library's wgmma kernels (forward and dX, decode, dW) and a
# CUDA-core one, by the names their mangled symbols hold
GMM_KERNELS = ("_Z2tc16gmm_wgmma_kernelILi2ELi1EE",
               "_Z3dec17gmm_decode_kernelILi8EE", "_Z2dw13gmm_dw_kernelE")
GMM_LOG = "".join(
    f"""ptxas info    : Compiling entry function '{k}' for 'sm_90a'
    0 bytes stack frame, {{spill}} bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
""" for k in GMM_KERNELS) + """ptxas info    : Compiling entry function '_Z14gmm_f32_kernelPKf' for 'sm_90a'
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers
"""


@pytest.mark.parametrize("spill,hgmma,drop,ok", [
    (0, 3, None, True), (16, 3, None, False), (0, 0, None, False),
    (0, 3, "gmm_dw_kernel", False)],
    ids=["clean", "spills", "no_wgmma", "missing_kernel"])
def test_tensor_core_report_gates_on_spills_and_wgmma(tmp_path, spill, hgmma,
                                                      drop, ok):
    """Phase 2's report: a tensor-core kernel that spills, a wgmma kernel
    without wgmma in its SASS, or a gmm wgmma kernel (forward and dX,
    decode, dW) missing from ptxas's report fails; a CUDA-core kernel's
    spills do not count."""
    head = "ptxas info    : Compiling"
    gmm_log = "".join(head + e for e in GMM_LOG.split(head)[1:]
                      if drop is None or drop not in e)

    class Build:
        @staticmethod
        def library_path(name):
            lib = tmp_path / f"lib{name}.so"
            log = PTXAS_LOG if name == "flash_attention" else gmm_log
            lib.with_suffix(".log").write_text(log.format(spill=spill))
            return lib

        @staticmethod
        def _nvcc():
            return "/toolkit/bin/nvcc"

    hgmma_lines = ["  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ"] * hgmma
    sass = {"flash_attention": ["Function : _Z2tc18flash_wgmma_kernelILi128EE",
                                *hgmma_lines],
            "moe_gmm": [line for k in GMM_KERNELS
                        for line in (f"Function : {k}", *hgmma_lines)]}
    lines, tools = [], set()

    def run(cmd, **_):
        tools.add(cmd[0])
        name = Path(cmd[-1]).stem[3:]
        return type("R", (), {"stdout": "\n".join(sass[name])})()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(chip_smoke, "log", lines.append)
        mp.setattr(chip_smoke.subprocess, "run", run)
        if ok:
            chip_smoke.tensor_core_report(Build)
            # cuobjdump from the toolkit whose nvcc built the libraries
            assert tools == {"/toolkit/bin/cuobjdump"}
            assert any("134 registers, 0 bytes spill" in ln for ln in lines)
            assert any(f"{{'wgmma_kernel': {hgmma}, 'gmm_decode_kernel': "
                       f"{hgmma}, 'gmm_dw_kernel': {hgmma}}}" in ln
                       for ln in lines)
        else:
            with pytest.raises(RuntimeError):
                chip_smoke.tensor_core_report(Build)


def test_ssd_kernel_phase_runs_on_cpu(kernels_patched):
    """Phase 3d at small shapes (timed, and an untimed edge shape)."""
    chip_smoke.phase_ssd_kernels(torch, device="cpu",
                                 cases=[(2, 37, 8, 16, 1, 16, 16)],
                                 edge_cases=[(2, 96, 6, 8, 3, 8, 24)])
    assert len(kernels_patched) == 4
    assert all("max_abs_err=0, 0 of the tolerance" in line
               for line in kernels_patched)
    assert sum("no PyTorch call computes the scan" in line
               for line in kernels_patched) == 2


def test_flash_and_ssd_bounds_count_bytes_and_flops():
    q = torch.empty(1, 700, 32, 112, dtype=torch.bfloat16)
    k = torch.empty(1, 700, 32, 112, dtype=torch.bfloat16)
    ms, by = chip_smoke.flash_bound_ms(q, k)
    t_ops = (4 * 112 * 32 * 700 * 701 // 2
             / chip_smoke.PEAK_FLOPS["bfloat16"] * 1e3)
    t_bytes = 4 * q.numel() * 2 / chip_smoke.HBM_BYTES_PER_S * 1e3
    assert by == "bytes" and t_bytes > t_ops
    assert ms == pytest.approx(t_bytes)
    x = torch.empty(1, 700, 112, 64)
    bm = torch.empty(1, 700, 1, 64)
    ms, by = chip_smoke.ssd_bound_ms(x, bm)
    assert by == "operations"
    assert ms == pytest.approx(4 * 700 * 112 * 64 * 64
                               / chip_smoke.PEAK_FLOPS["float32"] * 1e3)


def test_ssd_gate_at_the_main_path_scale_sees_a_zero_output(kernels_patched):
    """At the served models' random init the scan's y is tiny beside x, as
    here with B and C scaled by 1e-3: a kernel that wrote zeros for y
    stays inside the elementwise atol, and the normwise gate the main
    path runs refuses it."""
    gen = torch.Generator().manual_seed(0)
    x, dt, a, bm, cm = chip_smoke.ssd_inputs(torch, 1, 40, 8, 16, 1, 16,
                                             torch.float32, "cpu", gen)
    args = (x, dt, a, bm * 1e-3, cm * 1e-3)
    y, state = ssd_ops.ssd_chunked(*args, 16)
    assert float(y.abs().max()) < chip_smoke.SSD_TOL["float32"]
    out = chip_smoke.ssd_case_ms(torch, [args], 16, timed=False,
                                 elementwise=False)
    assert out["rel"] == 0.0 and out["y_over_x"] < 1e-4
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ssd_pkg, "ssd_scan",
                   lambda *a: (torch.zeros_like(y), state))
        with pytest.raises(RuntimeError, match="on y: normwise 1 "):
            chip_smoke.ssd_case_ms(torch, [args], 16, timed=False,
                                   elementwise=False)


@pytest.fixture
def hybrid_patched(kernels_patched):
    """Phases 10-11 on the CPU: every kernel wrapper's calls counted as
    launches."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ("decode_attention", "paged_decode_attention"):
            mp.setattr(attention, name, _counted(name))
        mp.setattr(attention, "flash_attention",
                   _counted("flash_attention", flash_ops))
        mp.setattr(mamba2, "ssd_scan", _counted_ssd())
        yield kernels_patched


def test_hybrid_phase_runs_on_cpu(hybrid_patched):
    """Phase 10 on reduced zamba2-7b: the launch gates of the dense and
    the paged engine, paged tokens = dense tokens, the logits gates, and
    both kernels at one prefill's inputs."""
    out = chip_smoke.phase_hybrid(torch, device="cpu", reduced=True,
                                  cache_len=64, lengths=(4, 40))
    text = "\n".join(hybrid_patched)
    dense, paged = out["dense"], out["paged"]
    assert dense["tokens"] == paged["tokens"]
    for run, decode in ((dense, "decode_attention"),
                        (paged, "paged_decode_attention")):
        assert run["counts"]["ssd_scan"] == 13 * run["stats"]["prefill_calls"]
        assert run["counts"]["flash_attention"] == \
            2 * run["stats"]["prefill_calls"]
        assert run["counts"][decode] == 2 * run["stats"]["decode_steps"]
    assert "equal to the dense engine's for 16/16 requests" in text
    assert out["prefill_rel"] == 0.0
    assert out["paths"]["ssd_scan"]["err"] == 0.0
    assert out["paths"]["flash_attention"]["bound_by"] in ("bytes",
                                                           "operations")
    assert text.count("rel_err=0 ") == 3    # two decode steps, one prefill


def test_hybrid_phase_gates_on_ssd_launches(hybrid_patched):
    """A prefill whose scans skip the kernel fails the launch gate."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mamba2, "ssd_scan", ssd_ops.ssd_chunked)
        with pytest.raises(RuntimeError, match="ssd_scan launched 0 times"):
            chip_smoke.phase_hybrid(torch, device="cpu", reduced=True,
                                    cache_len=64, lengths=(4, 40))


def test_mamba_phase_runs_on_cpu(hybrid_patched):
    """Phase 11 on reduced mamba2-780m: SSD launches = 3 layers x prefill
    calls, no attention kernel, the prefill logits gate."""
    out = chip_smoke.phase_mamba(torch, device="cpu", reduced=True,
                                 cache_len=64, lengths=(4, 40))
    assert out["counts"]["ssd_scan"] == 3 * out["stats"]["prefill_calls"]
    assert out["counts"]["flash_attention"] == 0
    assert out["prefill_rel"] == 0.0 and out["path"]["err"] == 0.0


def _ssd_tensors(dtype, n, p, length, offset=0):
    """x (1, length, 2, p) and B, C (1, length, 1, n) of ``dtype``; x
    starts ``offset`` elements into its storage."""
    x = torch.zeros(length * 2 * p + offset, dtype=dtype)[offset:]
    bm = torch.zeros(1, length, 1, n, dtype=dtype)
    return x.view(1, length, 2, p), bm, bm.clone()


@pytest.mark.parametrize("dtype,n,p,length,offset,path", [
    (torch.bfloat16, 64, 64, 700, 0, "chunked"),   # zamba2-7b's scans
    (torch.bfloat16, 128, 64, 9, 0, "chunked"),    # mamba2-780m's
    (torch.bfloat16, 64, 128, 64, 0, "chunked"),
    (torch.bfloat16, 64, 64, 8, 0, "step"),        # a few steps
    (torch.float32, 64, 64, 700, 0, "step"),       # f32 on CUDA cores
    (torch.bfloat16, 32, 64, 700, 0, "step"),
    (torch.bfloat16, 64, 32, 700, 0, "step"),
    (torch.bfloat16, 64, 64, 700, 1, "step"),      # x off 16 bytes
])
def test_ssd_path_names_the_entry_points_choice(dtype, n, p, length, offset,
                                                path):
    """ssd_path mirrors csrc/ssd.cu's rule (its note and the entry point):
    the chunked tensor-core path for aligned bf16 at N 64/128, P a
    multiple of 64 and more than 8 steps, the step path otherwise."""
    x, bm, cm = _ssd_tensors(dtype, n, p, length, offset)
    assert chip_smoke.ssd_path(x, bm, cm) == path
    if not offset:
        assert chip_smoke.ssd_path_for(dtype, n, p, length) == path
        assert chip_smoke.ssd_path_for(str(dtype).split(".")[-1], n, p,
                                       length) == path


def test_ssd_path_gate_reads_every_scan():
    """Phases 10-11's gate: all of a run's scans on the wanted path."""
    chip_smoke.check_ssd_paths("[t]", {"step": 0, "chunked": 81}, "chunked",
                               81)
    for paths in ({"step": 1, "chunked": 80}, {"step": 0, "chunked": 80}):
        with pytest.raises(RuntimeError, match="ssd_scan launches by path"):
            chip_smoke.check_ssd_paths("[t]", paths, "chunked", 81)


def test_hybrid_phase_gates_on_ssd_paths(hybrid_patched):
    """A run whose scans take another path than the one ssd_path_for
    names for the model's dtype and widths fails phase 10 (the reduced
    model is f32: every scan belongs on the step path)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mamba2, "ssd_scan",
                   _counted_ssd(lambda x, b, c: "chunked"))
        with pytest.raises(RuntimeError, match="ssd_scan launches by path"):
            chip_smoke.phase_hybrid(torch, device="cpu", reduced=True,
                                    cache_len=64, lengths=(4, 40))


def test_hybrid_phases_report_the_ssd_path(hybrid_patched):
    """Phases 10-11 on the CPU: every scan on the step path, as the card
    would run the reduced f32 models, and the path printed."""
    out = chip_smoke.phase_mamba(torch, device="cpu", reduced=True,
                                 cache_len=64, lengths=(4, 40))
    n = 3 * out["stats"]["prefill_calls"]
    assert out["ssd_paths"] == {"step": n, "chunked": 0}
    assert out["path"]["path"] == "step"
    assert any("all on its step path" in line for line in hybrid_patched)
    # the prefill profile reads device kernels only: none on the CPU
    assert out["prefill"] == {}
    assert any("a prefill's device busy and idle share not measured" in line
               for line in hybrid_patched)


SSD_PTXAS_LOG = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116ssd_chunk_kernelILi64EEEv14CUtensorMap_S1_S1_PKfS3_P13__nv_bfloat16Pfiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116ssd_chunk_kernelILi64EEEv14CUtensorMap_S1_S1_PKfS3_P13__nv_bfloat16Pfiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120ssd_step_bf16_kernelILi8EEEvPK13__nv_bfloat16PKfS5_S3_S3_PS1_Pfiiii' for 'sm_90a'
    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads
ptxas info    : Used 89 registers, used 1 barriers
"""


@pytest.mark.parametrize("spill,hmma,mma,ok", [
    (0, 6, True, True), (12, 6, True, False), (0, 0, True, False),
    (0, 0, False, True), (8, 0, False, False)],
    ids=["clean", "spills", "no_mma", "no_mma_wanted", "spills_no_mma"])
def test_kernel_report_gates_on_spills_and_mma(tmp_path, spill, hmma, mma,
                                               ok):
    """Phase 2's report of the SSD and conv libraries: any instantiation
    that spills fails it, and so does an SSD library without mma.sync
    (HMMA) in its SASS; the conv library is not asked for MMA."""
    class Build:
        @staticmethod
        def library_path(name):
            lib = tmp_path / f"lib{name}.so"
            lib.with_suffix(".log").write_text(
                SSD_PTXAS_LOG.format(spill=spill))
            return lib

        @staticmethod
        def _nvcc():
            return "/toolkit/bin/nvcc"

    sass = "\n".join(["HMMA.16816.F32.BF16 R8, R4, R12, R8"] * hmma)
    lines, tools = [], set()

    def run(cmd, **_):
        tools.add(cmd[0])
        return type("R", (), {"stdout": sass})()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(chip_smoke, "log", lines.append)
        mp.setattr(chip_smoke.subprocess, "run", run)
        if ok:
            chip_smoke.kernel_report(Build, "ssd", mma=mma)
            assert "2 kernels, registers 89-128, 0 bytes spill" in lines[0]
            assert tools == ({"/toolkit/bin/cuobjdump"} if mma else set())
            assert (f"{hmma} mma.sync (HMMA)" in lines[0]) == mma
        else:
            with pytest.raises(RuntimeError):
                chip_smoke.kernel_report(Build, "ssd", mma=mma)
