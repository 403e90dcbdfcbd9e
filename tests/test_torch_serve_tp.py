"""Exact tensor/expert-parallel serving in the port, on a gloo CPU
process group: ``Scheduler(tp=N)`` against single-device serving.

The reference's own sharded-serving test (``tests/test_serve_sharded.py``)
is red under this jax (``jax.make_mesh`` makes Explicit axes that
``with_sharding_constraint`` rejects), so its claim is held here on the
port: greedy tokens BITWISE equal to the single-device Scheduler, with
``compile_counts()`` unchanged.  Its setup is the reference snippet's
(``cache_dtype="float32"``, five requests, ``max_slots=3, max_len=32,
page_size=8, prefill_chunk=8``), on the reference's own params.

* One ``torch.multiprocessing.spawn`` of a world of 4 ranks, which
  serves at tp = 4 and at tp = 2 (``make_local_mesh(2)``: two replicas
  of a two-rank model axis), each rank serving in turn qwen2.5-3b (GQA
  with q-kv bias; at tp=4 its 2 kv heads split in halves over the ranks'
  columns and replicate in the pages, while its 4 q heads shard),
  musicgen-large (G = 1, sinusoidal positions), deepseek-v3-671b
  (experts sharded, MLA replicated) and jamba-v0.1-52b (Mamba
  replicated, MoE, GQA).  Each rank's tokens equal the port's
  single-device Scheduler's and the JAX Scheduler's, computed in the
  parent while the ranks run; the teacher-forced last logits of every
  served sequence, run through ``lm.prefill`` under the rank's mesh on
  its shards, equal the single-device ones within LOGIT_TOL.
* At tp=2 on qwen2.5-3b the int8 and the bf16 DCIM serves equal tp=1's
  token for token: the int8 weight scale is the whole weight's (a group
  maximum), the bf16 design's pre-alignment groups run along the
  replicated K.
* The gather (one broadcast a rank) equals a plain concatenation bit
  for bit at every dim, -0.0 signs included; the group max is the
  maximum.
* In-process: the ``tp=`` / ``mesh=`` checks, the tp=1 one-rank mesh
  (as sizes and as a ``DeviceMesh`` over a one-rank group), and the pump
  thread refused at tp > 1.

The children import neither jax nor the reference: jax is imported in
the parent's fixtures only.
"""
import dataclasses
import json
import os
import pickle
import tempfile
import time

import numpy as np
import pytest

pytest.importorskip("torch", reason="the PyTorch port's tests need torch")
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import bridge, configs
from repro_torch.core.precision import get as tget
from repro_torch.dist import sharding as shd
from repro_torch.dist import collectives
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import lm
from repro_torch.serve import Request, Scheduler
from repro_torch.sim.functional import DCIMMacroSim

ARCHS = ["qwen2.5-3b", "musicgen-large", "deepseek-v3-671b", "jamba-v0.1-52b"]
TPS = [2, 4]
KW = dict(max_slots=3, max_len=32, page_size=8, prefill_chunk=8)
TRACE = [(3, 4, 0), (9, 3, 0), (17, 5, 1), (5, 2, 1), (12, 3, 2)]   # (prompt, tokens, arrival)
DCIM_KW = dict(N=64, H=64, L=8, k=4)
DCIM_PRECS = ["int8", "bf16"]
WORLD = 4
JOBS_WAIT_S = 600
# The last logits of a rank-sharded forward against the single-device
# one.  Every product is the same full-length dot product, but at tp=4
# a rank's blocks are as narrow as 8 columns (half a head of the smoke
# widths, a quarter of a 64-wide FFN), where the CPU's GEMM and batched
# products take other kernels than at the full width: their float32
# sums then differ by about an ulp (observed at most 1.3e-6 at tp=4, 0
# at tp=2).  Tokens are held bitwise.
LOGIT_TOL = 1e-5


def _cfg(arch):
    return dataclasses.replace(configs.get_smoke_config(arch), cache_dtype="float32")


def _requests(cls=Request):
    rng = np.random.default_rng(0)
    return [cls(prompt=rng.integers(1, 64, p).astype(np.int32), n_tokens=t, rid=i, arrival=a)
            for i, (p, t, a) in enumerate(TRACE)]


def _last_logits(params, cfg, results):
    """The logits after each served sequence but its last token, one
    forward a request."""
    out = []
    for r in results:
        seq = np.asarray(r.tokens[:-1], np.int64)[None]
        _, lg = lm.prefill(params, {"tokens": torch.as_tensor(seq)}, cfg)
        out.append(lg[0, -1].tolist())
    return out


def _serve(cfg, params, **kw):
    """(tokens per request, compile_counts, the Scheduler, results)."""
    sched = Scheduler(cfg, params, **{**KW, **kw})
    res = sched.serve(_requests())
    return [list(map(int, r.tokens)) for r in res], sched.compile_counts(), sched, res


def _counts_json(c):
    return {"decode": c["decode"], "prefill": sorted(map(list, c["prefill"])),
            "total": c["total"]}


def _forms(world):
    """The gather against a concatenation at every dim, -0.0 included,
    and the group max."""
    g = dist.group.WORLD
    me = dist.get_rank()
    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4) * (me + 1) - 7.0
    x[0, 0, 0] = -0.0
    xs = [torch.arange(24, dtype=torch.float32).reshape(2, 3, 4) * (r + 1) - 7.0
          for r in range(world)]
    for t in xs:
        t[0, 0, 0] = -0.0
    ok = {}
    for dim in range(3):
        y = collectives.all_gather(x, dim, g)
        want = torch.cat(xs, dim)
        ok[f"gather/{dim}"] = bool(torch.equal(y, want)
                                   and torch.equal(torch.signbit(y), torch.signbit(want)))
    ok["max"] = bool(torch.equal(collectives.group_max(x, g), torch.stack(xs).amax(0)))
    return ok


def _rank_main(rank, world, init, out_dir):
    """One rank: every job's serve at its tp on this world, recorded as
    JSON.  The jobs come through a file the parent writes once the
    reference's params exist: arguments too large for a pipe's buffer
    would start the ranks one after another.  A rank stops waiting for
    them when the parent has exited or removed the directory (a failed
    fixture)."""
    parent = os.getppid()
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        rec = {"forms": _forms(world), "serves": {}}
        jobs_file = os.path.join(out_dir, "jobs.pkl")
        deadline = time.monotonic() + JOBS_WAIT_S
        while not os.path.exists(jobs_file):
            if os.getppid() != parent or not os.path.isdir(out_dir):
                raise RuntimeError("the parent gave up before writing the jobs")
            if time.monotonic() > deadline:
                raise TimeoutError(f"no jobs after {JOBS_WAIT_S} s")
            time.sleep(0.05)
        with open(jobs_file, "rb") as f:
            jobs = pickle.load(f)
        for job in jobs:
            cfg = _cfg(job["arch"])
            params = bridge.params_from_numpy(job["params"], "cpu")
            sim = None
            if job["dcim"] is not None:
                sim = DCIMMacroSim(precision=tget(job["dcim"]), **DCIM_KW)
            toks, counts, sched, res = _serve(cfg, params, tp=job["tp"], dcim_sim=sim)
            one = {"tokens": toks, "counts": _counts_json(counts)}
            if sim is None:
                with torch.no_grad(), shd.use_mesh(sched.mesh_ctx):
                    one["logits"] = _last_logits(sched.params, cfg, res)
                one["shapes"] = {p: list(t.shape) for p, t in shd.tree_paths(sched.params)}
            rec["serves"][job["key"]] = one
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


# ------------------------------- fixtures -------------------------------------
@pytest.fixture(scope="module")
def served():
    """(reference, ranks).  reference, per arch: the reference's params
    (numpy), the JAX Scheduler's tokens, and the port's single-device
    tokens, counts and last logits; the port's single-device DCIM tokens
    on qwen.  ranks: {tp: [each rank's records at that tp]}, from one
    spawn of WORLD ranks, which start while the parent draws the
    reference's params and serve while it computes the reference."""
    import jax

    from repro import configs as jconfigs
    from repro.models import lm as jlm
    from repro.serve import Request as JRequest
    from repro.serve import Scheduler as JScheduler

    with tempfile.TemporaryDirectory() as d:
        init = "file://" + os.path.join(d, "store")
        procs = mp.start_processes(_rank_main, args=(WORLD, init, d), nprocs=WORLD,
                                   join=False, start_method="spawn")
        jcfgs = {a: dataclasses.replace(jconfigs.get_smoke_config(a), cache_dtype="float32")
                 for a in ARCHS}
        params = {a: jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(0), jcfgs[a]))
                  for a in ARCHS}
        jobs = [dict(key=f"{tp}/{a}", tp=tp, arch=a, params=params[a], dcim=None)
                for tp in TPS for a in ARCHS]
        jobs += [dict(key=f"2/dcim-{p}", tp=2, arch="qwen2.5-3b", params=params["qwen2.5-3b"],
                      dcim=p) for p in DCIM_PRECS]
        with open(os.path.join(d, "jobs.tmp"), "wb") as f:
            pickle.dump(jobs, f)
        os.replace(os.path.join(d, "jobs.tmp"), os.path.join(d, "jobs.pkl"))
        ref = {}
        for a in ARCHS:
            jtoks = [list(map(int, r.tokens))
                     for r in JScheduler(jcfgs[a], params[a], **KW).serve(_requests(JRequest))]
            cfg = _cfg(a)
            tparams = bridge.params_from_numpy(params[a], "cpu")
            toks, counts, _, res = _serve(cfg, tparams)
            with torch.no_grad():
                logits = _last_logits(tparams, cfg, res)
            ref[a] = dict(params=params[a], jax_tokens=jtoks, tokens=toks,
                          counts=_counts_json(counts), logits=logits)
        tparams = bridge.params_from_numpy(params["qwen2.5-3b"], "cpu")
        for prec in DCIM_PRECS:
            sim = DCIMMacroSim(precision=tget(prec), **DCIM_KW)
            ref[f"dcim-{prec}"] = _serve(_cfg("qwen2.5-3b"), tparams, dcim_sim=sim)[0]
        while not procs.join():
            pass
        recs = []
        for r in range(WORLD):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                recs.append(json.load(f))
    ranks = {tp: [dict(forms=rec["forms"],
                       serves={k.split("/", 1)[1]: v for k, v in rec["serves"].items()
                               if k.startswith(f"{tp}/")}) for rec in recs]
             for tp in TPS}
    return ref, ranks


@pytest.fixture(scope="module")
def reference(served):
    return served[0]


@pytest.fixture(scope="module")
def ranks(served):
    return served[1]


# ------------------------------- spawned worlds ---------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tp", TPS)
def test_tp_serving_bitwise_exact(ranks, reference, tp, arch):
    ref = reference[arch]
    assert ref["tokens"] == ref["jax_tokens"], "single-device port vs JAX Scheduler"
    for r, rec in enumerate(ranks[tp]):
        got = rec["serves"][arch]
        assert got["tokens"] == ref["tokens"], (tp, arch, r)
        assert got["counts"] == ref["counts"], (tp, arch, r)
        gap = max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
                  for a, b in zip(got["logits"], ref["logits"]))
        assert gap <= LOGIT_TOL, (tp, arch, r, gap)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tp", TPS)
def test_tp_ranks_hold_their_shards(ranks, reference, tp, arch):
    """Every rank served on its blocks: the head's vocab, the q, k and v
    columns (by columns: at tp=4 qwen's and jamba's 2 kv heads split in
    halves, which ``gqa_qkv`` gathers, while their pages replicate), the
    FFN and expert banks at 1/tp, the MLA factors and every Mamba
    parameter whole, and the ranks agree on every shape."""
    shapes = [rec["serves"][arch]["shapes"] for rec in ranks[tp]]
    assert all(s == shapes[0] for s in shapes)
    full = {p: list(np.shape(a)) for p, a in shd.tree_paths(reference[arch]["params"])}
    local = shapes[0]
    assert local.keys() == full.keys()
    cfg = _cfg(arch)
    split = 0
    for p, s in local.items():
        f = full[p]
        if p == "head/w" or p.endswith(("mixer/wq/w", "wk/w", "wv/w", "w_up/w", "w_gate/w")):
            assert s == f[:-1] + [f[-1] // tp], p
        elif p.endswith(("ffn/w_gate", "ffn/w_up", "ffn/w_down")):
            assert s == f[:-3] + [f[-3] // tp] + f[-2:], p      # experts divide here
        elif any(k in p for k in ("/q_a/", "/q_b/", "/kv_a/", "/kv_b/", "/wo/", "/in_proj/",
                                  "/out_proj/", "/x_proj/", "/dt_proj/", "A_log", "conv_w",
                                  "embed/", "router/")):
            assert s == f, p
        split += s != f
    assert split > 0


@pytest.mark.parametrize("prec", DCIM_PRECS)
def test_tp2_dcim_serving_bitwise_exact(ranks, reference, prec):
    for rec in ranks[2]:
        assert rec["serves"][f"dcim-{prec}"]["tokens"] == reference[f"dcim-{prec}"]


def test_gather_forms_and_group_max_exact(ranks):
    for rec in ranks[2]:
        assert rec["forms"] and all(rec["forms"].values()), rec["forms"]


# ------------------------------- in-process -----------------------------------
@pytest.fixture(scope="module")
def qwen():
    cfg = _cfg("qwen2.5-3b")
    g = torch.Generator("cpu")
    g.manual_seed(0)
    return cfg, lm.init(cfg, g, "cpu")


def test_tp_knob_validation(qwen):
    cfg, params = qwen
    with pytest.raises(ValueError, match="not both"):
        Scheduler(cfg, params, tp=1, mesh={"model": 1})
    with pytest.raises(ValueError, match="exceeds"):
        Scheduler(cfg, params, tp=2)
    with pytest.raises(ValueError, match=">= 1"):
        Scheduler(cfg, params, tp=0)


def test_tp1_mesh_serving_exact_single_device(qwen):
    """The mesh path itself (params and pool laid out by the serving
    rules, the serving context around every step) on one rank: as sizes
    with no process group, and as a DeviceMesh over a one-rank group."""
    cfg, params = qwen
    ref, counts, _, _ = _serve(cfg, params)
    toks, c, sched, _ = _serve(cfg, params, tp=1)
    assert toks == ref and c == counts
    assert sched.mesh_ctx.exact and sched.mesh_ctx.size("model") == 1
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", init_method="file://" + os.path.join(d, "s"),
                                rank=0, world_size=1)
        try:
            for kw in (dict(tp=1), dict(mesh=make_local_mesh(1))):
                toks, c, sched, _ = _serve(cfg, params, **kw)
                assert toks == ref and c == counts
                assert sched.mesh_ctx.mesh is not None
        finally:
            dist.destroy_process_group()


def test_pump_refused_under_tp(qwen):
    """A two-rank model axis (as sizes: rank 0's shards, no group is
    needed to build it) refuses the pump thread."""
    cfg, params = qwen
    sched = Scheduler(cfg, params, mesh={"model": 2}, **KW)
    assert sched.params["head"]["w"].shape[-1] == cfg.vocab_size // 2
    with pytest.raises(RuntimeError, match="pump thread"):
        sched.session().start()
