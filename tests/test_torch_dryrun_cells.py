"""Every cell of the port's dry run (launch/dryrun.cells("single")) on
meta tensors at the (16, 16) mesh: each cell of every family (dense, MoE,
audio, vlm, ssm, hybrid) records ``status: "ok"`` with positive FLOPs and
bytes per device and JAX's ``model_flops_global``.
tests/test_torch_dryrun.py holds two cells' numbers to JAX's."""
import pytest

from repro_torch.configs import base
from repro_torch.launch import dryrun

CELLS = [(a, s) for a, s, _ in dryrun.cells("single")]


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_cell(tmp_path, arch, shape):
    rec = dryrun.run_and_record(arch, shape, False, out_dir=tmp_path)
    assert (tmp_path / f"{dryrun.cell_tag(arch, shape, False)}.json"
            ).exists()
    cfg = base.get_config(arch)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["model_flops_global"] == dryrun.model_flops(
        cfg, base.SHAPES[shape])
    assert rec["collective_bytes_per_device"] > 0
    assert rec["bottleneck"] in ("compute_s", "memory_s", "collective_s")
