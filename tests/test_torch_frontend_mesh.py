"""``serve --http`` over a mesh of more than one rank (launch/mesh.py), on
the CPU: two spawned gloo ranks at (2, 1) and (1, 2) (job "frontend" of
tests/_torch_mesh_ranks.py).  Rank 0 serves HTTP; its worker broadcasts
each loop iteration's engine calls (serving/frontend/router.MeshControl)
and rank 1's follower applies them.  The flow: four requests with the
workers paused (one answered 429), two admitted and one shed by its queue
deadline, three pairs of one streamed and one gathered request, a graceful
drain.

* every completed request on every rank has the same tokens and ticks as
  on rank 0, bit for bit, and both ranks ran the same ticks;
* rank 0's requests equal a one-process ``build_frontend`` on the same
  requests (no near-tie is recorded at these sizes), with no mask left;
* when rank 0's worker crashes, it broadcasts an abort and the follower
  exits non-zero (``MeshAborted``), while rank 0 answers its clients.
"""
import functools

import _torch_mesh_ranks as ranks
import pytest
import torch

from repro_torch.configs import base

torch.set_num_threads(1)

MESHES = [(2, 1), (1, 2)]


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def served(request, tmp_path_factory):
    data, model = request.param
    return ranks.spawn("frontend", data * model,
                       tmp_path_factory.mktemp("frontend"), timeout=240.0,
                       data=data, model=model)["ranks"]


@functools.lru_cache(maxsize=None)
def one_process():
    return ranks.frontend_flow()


def _check_flow(res):
    """The first four requests: one 429 at admission (queue full), one
    shed past its queue deadline, two served; every later one served,
    with no mask left; the tokens each row received are its engine's."""
    rows = res["rows"]
    first = [r for _, r in rows[:4]]
    overloaded = [r for r in first if r.get("http") == 429]
    assert len(overloaded) == 1
    late = [r for r in first if "deadline" in str(r.get("error"))]
    assert len(late) == 1
    assert sorted(r["status"] for r in first) == ["ok", "ok", "shed",
                                                  "shed"]
    assert all(r["status"] == "ok" for _, r in rows[4:])
    mask_id = base.get_config("llada-8b", smoke=True).mask_id
    for i, r in rows:
        if r["status"] == "ok":
            toks, ticks = res["done"][i]
            assert r["token_ids"] == toks[ranks.FRONT_PROMPT:]
            assert mask_id not in toks[ranks.FRONT_PROMPT:] and ticks > 0


def test_one_process_flow():
    _check_flow(one_process())


def test_rank0_serves_sheds_and_drains(served):
    _check_flow(served[0])
    records, seconds = served[0]["control"]
    assert records >= served[0]["ticks_total"] > 0 and seconds > 0


def test_every_rank_equals_rank0(served):
    lead = served[0]
    for other in served[1:]:
        assert other["done"] == lead["done"]
        assert other["ticks_total"] == lead["ticks_total"]
        assert other["follower_ticks"] > 0


def test_rank0_equals_one_process(served):
    want = one_process()["done"]
    got = served[0]["done"]
    assert len(got) == 7 and set(got) == set(want)
    for i in got:
        assert got[i] == want[i], i


def test_follower_exits_nonzero_when_rank0_aborts(tmp_path):
    res = ranks.spawn("frontend", 2, tmp_path, timeout=120.0, codes=(0, 1),
                      data=2, model=1, abort=True)
    assert res["done"] == {}
    assert all(r["status"] == "shed" for _, r in res["rows"])
    assert any("crashed" in str(r.get("error")) for _, r in res["rows"])
