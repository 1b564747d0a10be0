"""The port's dry run (launch/dryrun.py) on meta tensors at the
production mesh, on the CPU, against JAX's placements and model-FLOP
formula.

* llada-8b decode_32k and qwen2-0.5b train_4k at (16, 16) are ``ok``;
  their parameter (and cache) bytes per device equal the shard that JAX's
  placements (launch/sharding.make_rules on ``jax.sharding.AbstractMesh``)
  give one device; ``model_flops_global`` is 6 N D (train) or
  2 N_active D (inference) from JAX's ``cfg.active_param_count()``.
* llada-8b decode: the FLOPs per device x 256 within 2% of the (1, 1)
  trace's (a one-device step of the whole batch), and every layer
  all-reduces exactly twice over ``model`` (after ``wo`` and after the
  down product), each rows x d x 4 bytes of f32 partials.
* the multi-pod mesh runs with pod x data as the data axis (512 cards).
* ssm and hybrid cells record ``status: "error"`` and the message; the
  CLI writes its records where ``--out-dir`` says.
* the remat variant traces, its FLOPs counting the backward's recompute.

The JAX driver (``repro.launch.dryrun``) is never imported here: its first
line sets XLA_FLAGS to 512 host devices for the whole process.
"""
import json
import sys

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro import sharding as jsh
from repro.configs import base as jbase
from repro.launch import sharding as jls
from repro.launch import steps as jsteps
from repro.models.registry import build_model as jbuild
from repro_torch.launch import dryrun

CHIPS = 256


def jax_bytes(arch, shape_name, mesh_shape):
    """{"params", "cache"}: bytes per device under JAX's placements."""
    cfg = jbase.get_config(arch)
    names = ("pod", "data", "model") if len(mesh_shape) == 3 \
        else ("data", "model")
    jm = AbstractMesh(mesh_shape, names)
    model = jbuild(cfg)
    shape = jbase.SHAPES[shape_name]
    pol = jsteps.ServePolicy()
    with jsh.use_context(jm, jls.make_rules(cfg, jm)):
        specs = jsteps.input_specs(model, shape, pol)
        shardings = jsteps.input_shardings(model, shape, jm, specs, pol)
    sizes = dict(zip(names, mesh_shape))

    def nbytes(tree, shard_tree):
        tot = 0.0
        for sds, sh in zip(jax.tree.leaves(tree), jax.tree.leaves(
                shard_tree, is_leaf=lambda x: isinstance(
                    x, jax.sharding.NamedSharding))):
            n = int(np.prod(sds.shape)) if sds.shape else 1
            parts = int(np.prod([sizes[a] for ax in sh.spec
                                 if ax is not None for a in (
                                     (ax,) if isinstance(ax, str) else ax)]))
            tot += n * sds.dtype.itemsize / parts
        return tot

    out = {"params": nbytes(specs["params"], shardings["params"])}
    if "cache" in specs:
        out["cache"] = nbytes(specs["cache"], shardings["cache"])
    return out


@pytest.fixture(scope="module")
def cells():
    return {("llada-8b", "decode_32k"): dryrun.run_cell("llada-8b",
                                                        "decode_32k"),
            ("qwen2-0.5b", "train_4k"): dryrun.run_cell("qwen2-0.5b",
                                                        "train_4k")}


@pytest.mark.parametrize("arch,shape", [("llada-8b", "decode_32k"),
                                        ("qwen2-0.5b", "train_4k")])
def test_cells_ok_with_jax_bytes_and_model_flops(cells, arch, shape):
    rec = cells[arch, shape]
    assert rec["status"] == "ok" and rec["chips"] == CHIPS
    assert rec["mesh"] == "16x16" and rec["bottleneck"] in rec["roofline"]
    want = jax_bytes(arch, shape, (16, 16))
    assert rec["param_bytes_per_device"] == want["params"]
    assert rec["cache_bytes_per_device"] == want.get("cache", 0.0)
    cfg = jbase.get_config(arch)
    sh = jbase.SHAPES[shape]
    tokens = sh.global_batch * (sh.seq_len if sh.kind == "train"
                                else sh.block_length)
    factor = 6.0 if sh.kind == "train" else 2.0
    assert rec["model_flops_global"] == factor * \
        cfg.active_param_count() * tokens
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["useful_flops_ratio"] == pytest.approx(
        rec["model_flops_global"] / (rec["flops_per_device"] * CHIPS))
    assert any("not comparable" in n for n in rec["notes"])


def test_decode_flops_split_over_the_mesh(cells):
    whole = dryrun.run_cell("llada-8b", "decode_32k", mesh_shape=(1, 1))
    assert whole["status"] == "ok" and whole["chips"] == 1
    assert not whole["collectives"]
    per = cells["llada-8b", "decode_32k"]["flops_per_device"]
    assert abs(per * CHIPS - whole["flops_per_device"]) <= \
        0.02 * whole["flops_per_device"]


def test_two_model_all_reduces_a_layer():
    cfg, policy = dryrun.variant_config("llada-8b")
    shape = dryrun.configs.SHAPES["decode_32k"]
    costs = dryrun.trace_cell(cfg, shape, policy, (16, 16))
    rows = shape.global_batch // 16 * shape.block_length
    partial = rows * cfg.d_model * 4
    sums = [b for op, axis, b in costs["collective_log"]
            if op == "all_reduce_sum" and axis == "model"]
    assert sums.count(partial) == 2 * cfg.n_layers
    # the rest: the embedding's exact sum (bf16 rows) and the sampling
    # combine's per-row sums
    assert sorted(b for b in sums if b != partial) == [
        rows * 4, rows * cfg.d_model * 2]
    assert not any(axis == "data" for _, axis, _ in costs["collective_log"])


def test_multi_pod_cell():
    rec = dryrun.run_cell("qwen2-0.5b", "decode_32k", multi_pod=True)
    assert rec["status"] == "ok" and rec["chips"] == 512
    assert rec["mesh"] == "2x16x16"
    want = jax_bytes("qwen2-0.5b", "decode_32k", (2, 16, 16))
    assert rec["param_bytes_per_device"] == want["params"]
    assert rec["cache_bytes_per_device"] == want["cache"]


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-2b"])
def test_recurrent_cells_record_the_error(tmp_path, arch):
    """The recurrent families' cells once recorded the error of their
    missing tensor-parallel body; now their record is a traced cell's,
    saved as returned, with JAX's parameter and cache bytes per device."""
    rec = dryrun.run_and_record(arch, "decode_32k", False,
                                out_dir=tmp_path)
    assert rec["status"] == "ok", rec.get("traceback")
    assert "error" not in rec
    saved = json.loads((tmp_path / f"{arch}__decode_32k__16x16.json"
                        ).read_text())
    assert saved["status"] == "ok"
    assert saved["flops_per_device"] == rec["flops_per_device"]
    want = jax_bytes(arch, "decode_32k", (16, 16))
    assert rec["param_bytes_per_device"] == want["params"]
    assert rec["cache_bytes_per_device"] == want["cache"]


def test_cli_writes_records(tmp_path, capsys):
    assert dryrun.main(["--arch", "whisper-medium", "--shape",
                        "decode_32k", "--out-dir", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "whisper-medium__decode_32k__16x16.json"
                      ).read_text())
    assert rec["status"] == "ok" and rec["kind"] == "decode"
    assert dryrun.main(["--arch", "whisper-medium", "--shape",
                        "decode_32k", "--out-dir", str(tmp_path),
                        "--skip-existing"]) == 0
    assert "[skip]" in capsys.readouterr().out
    # JAX's 14 variants, every one traced
    assert sorted(dryrun.VARIANTS) == sorted([
        "baseline", "split", "losschunk", "split_losschunk", "padheads48",
        "padheads48_split", "padheads_g3", "moe_global", "remat",
        "bf16score", "split_bf16", "losschunk_bf16", "remat_bf16",
        "bigchunk", "padheads48_split_bf16", "split_losschunk_bf16"])
    assert not hasattr(dryrun, "NOT_PORTED")
    assert dryrun.RESULTS.name == "dryrun_torch"


# a variant that sets score_dtype or attn_chunk: (cell, the variant whose
# bytes it must equal)
SCORE_VARIANTS = {
    "bf16score": (("llada-8b", "decode_32k"), "baseline"),
    "remat_bf16": (("qwen2-0.5b", "train_4k"), "remat"),
    "bigchunk": (("llada-8b", "decode_32k"), "baseline"),
    "split_losschunk_bf16": (("llada-8b", "decode_32k"), "split_losschunk"),
}


@pytest.mark.parametrize("variant", sorted(SCORE_VARIANTS))
def test_cli_refuses_variants_without_effect(cells, tmp_path, variant):
    """The variants that set score_dtype or attn_chunk once were refused;
    the CLI now writes their records under their own names.  On the card
    attention's scores never leave on-chip memory, so a bf16-score
    variant moves the bytes of its base variant, and its record says why;
    bigchunk (attn_chunk, which f32 scores do not read) traces as the
    baseline does: the same bytes, FLOPs, ops and collectives."""
    (arch, shape), base_name = SCORE_VARIANTS[variant]
    assert dryrun.main(["--arch", arch, "--shape", shape, "--variant",
                        variant, "--out-dir", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / f"{arch}__{shape}__16x16__{variant}.json"
                      ).read_text())
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["variant"] == variant
    base = cells[arch, shape] if base_name == "baseline" else \
        dryrun.run_cell(arch, shape, variant=base_name)
    for key in ("bytes_per_device", "aten_ops", "param_bytes_per_device",
                "cache_bytes_per_device", "collectives",
                "collective_bytes_per_device", "model_flops_global"):
        assert rec[key] == base[key], key
    bf16 = dryrun.VARIANTS[variant].get("cfg", {}).get("score_dtype")
    assert (dryrun.SCORES_NOTE in rec["notes"]) == (bf16 == "bfloat16")
    if bf16 is None:
        assert rec["flops_per_device"] == base["flops_per_device"]


def test_remat_variant_traces_with_the_recompute(cells):
    """JAX's remat variant (checkpoint_dots over each layer) traces: the
    train step's backward recomputes every layer's ops but its matrix
    products, and attention, a kernel on the card, whole (its products
    counted from its shapes), so the FLOPs per device exceed the
    baseline's, and the placements are the baseline's."""
    rec = dryrun.run_cell("qwen2-0.5b", "train_4k", variant="remat")
    base = cells["qwen2-0.5b", "train_4k"]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["variant"] == "remat"
    assert rec["flops_per_device"] > base["flops_per_device"]
    assert rec["param_bytes_per_device"] == base["param_bytes_per_device"]
    assert rec["model_flops_global"] == base["model_flops_global"]


def test_jax_dryrun_never_imported():
    assert "repro.launch.dryrun" not in sys.modules


def test_cli_assigned_only_skips_llada(tmp_path, monkeypatch, capsys):
    """``--assigned-only`` skips the extra paper models (``llada-*``), as
    JAX's dry run does: ``--all`` runs every other cell, and a llada cell
    named alone writes nothing, while another arch's cell still traces on
    meta tensors and writes its record."""
    ran = []
    monkeypatch.setattr(dryrun, "run_and_record",
                        lambda arch, shape, mp, variant, out_dir: ran.append(
                            (arch, shape, mp)) or {"status": "ok",
                                                   "wall_s": 0.0})
    assert dryrun.main(["--all", "--assigned-only",
                        "--out-dir", str(tmp_path)]) == 0
    every = list(dryrun.cells("single"))
    assert ran == [c for c in every if not c[0].startswith("llada")]
    assert any(c[0].startswith("llada") for c in every)
    monkeypatch.undo()
    assert dryrun.main(["--arch", "llada-8b", "--shape", "decode_32k",
                        "--assigned-only", "--out-dir", str(tmp_path)]) == 0
    assert not list(tmp_path.glob("llada-8b*"))
    assert dryrun.main(["--arch", "whisper-medium", "--shape", "decode_32k",
                        "--assigned-only", "--out-dir", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "whisper-medium__decode_32k__16x16.json"
                      ).read_text())
    assert rec["status"] == "ok"
