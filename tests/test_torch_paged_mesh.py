"""The paged pool under a mesh (``EngineConfig(pool="paged", mesh=...)``:
core/diffusion.get_paged_tick_fn and PagedMegatick over the SPMD tick) on
the CPU, against the port's one-rank paged engine and the slot pool on the
same mesh.

Each mesh runs as spawned gloo ranks (tests/_torch_mesh_ranks.py, job
"paged"): (2, 1), JAX's tests/test_paged_cache.py case, whose slots shard
over ``data`` (each rank gathers, ticks and scatters its own slots'
pages), and (1, 2), whose LM head shards over ``model``.  The smoke
llada-8b serves JAX's case (mode none, three requests on two slots) and
tests/test_torch_paged.py's shared-prefix trace in modes none and warm at
K = 1 and the megatick (K = 4), and a warm run with a preempt after two
ticks.  Tokens, per-request ticks and CommitEvent keys are compared exactly,
and so are the pool's stats (prefix hits, pages, spills).
"""
import _torch_mesh_ranks as ranks
import pytest
import torch

from repro_torch.launch import mesh as mesh_lib

torch.set_num_threads(1)

MESHES = [(2, 1), (1, 2)]
RUNS = [("none", 1), ("none", 4), ("warm", 1), ("warm", 4)]


@pytest.fixture(scope="module", params=MESHES,
                ids=lambda m: f"{m[0]}x{m[1]}")
def mesh_run(request, tmp_path_factory):
    data, model = request.param
    return ranks.spawn("paged", data * model,
                       tmp_path_factory.mktemp("paged"), timeout=240.0,
                       data=data, model=model)


@pytest.fixture(scope="module")
def one_rank():
    return ranks.paged_results()


def test_jax_case_matches_one_rank_and_slot_pool(mesh_run, one_rank):
    got = mesh_run["jax case", "paged"]
    assert got == one_rank["jax case", "paged"]
    assert got == mesh_run["jax case", "slot"]
    assert len(got[0]) == 3


@pytest.mark.parametrize("mode,k", RUNS, ids=[f"{m}-k{k}" for m, k in RUNS])
def test_engine_matches_one_rank_and_slot_pool(mesh_run, one_rank, mode, k):
    got = mesh_run[mode, k, "paged"]
    assert got == one_rank[mode, k, "paged"]
    assert got == mesh_run[mode, k, "slot"]
    stats = mesh_run["stats", mode, k]
    assert stats == one_rank["stats", mode, k]
    assert stats["prefix_hits"] == 2 and stats["in_use"] == 0


def test_preempt_restore_under_mesh(mesh_run, one_rank):
    """A preempted request restores at the next admission, into whichever
    slot frees first (on (2, 1) possibly another rank's): its tokens and
    every CommitEvent equal the uninterrupted run's and one rank's."""
    assert mesh_run["preempt stats"] == (1, 1)
    assert mesh_run["preempt"] == mesh_run["preempt base"]
    assert mesh_run["preempt"] == one_rank["preempt"]


def test_one_by_one_mesh_equals_no_mesh(one_rank):
    """A (1, 1) gloo mesh in this process: the paged engine's runs equal
    the one-rank engine's."""
    got = ranks.paged_results(mesh_lib.make_debug_mesh(1, 1, "cpu"))
    for key in one_rank:
        assert got[key] == one_rank[key], key
