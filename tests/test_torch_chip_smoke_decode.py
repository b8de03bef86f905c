"""chip_smoke.py's phase-2 report of the decode kernels, rehearsed on the
CPU with a fake build: the script refuses to run without a card, so the
report's gates (no spills, mma.sync in the bf16 path's SASS) are
exercised here first."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

PTXAS_LOG = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123decode_attention_kernelI13__nv_bfloat16Li128ENS_10TensorRowsILi128ELi1EEELb0ELi64EEEvPKT_S7_S7_PKiPS5_NS_6LayoutEii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_123decode_attention_kernel
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123decode_attention_kernelIfLi128ENS_8CoreRowsIfLi128ELi4EEELb1ELi512EEEvPKT_S6_S6_PKiPS4_NS_6LayoutEii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_123decode_attention_kernel
    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads
ptxas info    : Used 106 registers, used 1 barriers
"""


@pytest.mark.parametrize("spill,hmma,ok", [(0, 4, True), (12, 4, False),
                                           (0, 0, False)],
                         ids=["clean", "spills", "no_mma"])
def test_decode_report_gates_on_spills_and_mma(tmp_path, spill, hmma, ok):
    """A decode kernel that spills (the f32 CUDA-core one here), or a
    library without mma.sync in its SASS, fails phase 2; a clean build
    prints the register range, the cluster size and the HMMA count."""
    class Build:
        @staticmethod
        def library_path(name):
            lib = tmp_path / f"lib{name}.so"
            lib.with_suffix(".log").write_text(PTXAS_LOG.format(spill=spill))
            return lib

        @staticmethod
        def _nvcc():
            return "/toolkit/bin/nvcc"

    class Lib:
        @staticmethod
        def decode_attention_cluster_blocks():
            return 8

    sass = "\n".join(["HMMA.16816.F32.BF16 R24, R4, R8, R24"] * hmma)
    lines, tools = [], set()

    def run(cmd, **_):
        tools.add(cmd[0])
        return type("R", (), {"stdout": sass})()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(chip_smoke, "log", lines.append)
        mp.setattr(chip_smoke.subprocess, "run", run)
        if ok:
            chip_smoke.decode_report(Build, Lib)
            assert tools == {"/toolkit/bin/cuobjdump"}
            assert lines == [
                "[build] decode_attention: 2 kernels, registers 106-168, 0 "
                "bytes spill stores; clusters of 8 blocks; 4 mma.sync (HMMA) "
                "instructions in the SASS"]
        else:
            with pytest.raises(RuntimeError):
                chip_smoke.decode_report(Build, Lib)


def test_ratios_name_each_yardstick():
    assert chip_smoke.ratios(0.01, sdpa=0.02, bound=0.004) == \
        "kernel/sdpa 0.50x, kernel/bound 2.50x"
