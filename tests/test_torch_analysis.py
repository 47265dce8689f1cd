"""The port's analysis layer (``analysis/{op_trace,roofline,top_ops,
reanalyze}.py``) against the reference's and against closed forms:

* dot FLOPs: the recorder's count of a prefill step and of a one-token
  decode step of the reduced yi-9b, gemma3-12b and deepseek-v2 (float32,
  one CPU device, the kernel sites counted in their plain form) against
  ``repro.analysis.hlo.analyze`` on the reference's compiled HLO of the
  same step, within 1% (they agree exactly here); and the train step of
  the reduced yi-9b under ``remat="dots"``, whose ratio to the
  reference's lies in the range its remat implies (see
  ``test_train_flops_follow_the_remat``);
* collective wire bytes: the reduced yi-9b prefill under TP 2 x DP 2 on
  a fake process group of 4 ranks, each kind equal to its closed form;
* the kernel sites' costs (pairs, valid keys, bytes) and the recorder's
  one record a site, its temp bytes on a hand-checked sequence, the
  roofline's arithmetic on hand-built records, ``top_ops``'s ranking, and
  ``reanalyze`` reproducing a production dry-run's terms from its saved
  records alone.

Tolerances: 1% on dot FLOPs (the counts match exactly here), exact
everywhere else (integer counts, float arithmetic on
exact inputs compared with ``pytest.approx`` at 1e-12)."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis.hlo import analyze
from repro.config import reduced_config as j_reduced
from repro.launch import steps as JS
from repro.models import model as JM
from repro.optim.adamw import adamw_init as j_adamw_init
from repro_torch import sharding as sh
from repro_torch.analysis import op_trace as OT
from repro_torch.analysis import roofline as RF
from repro_torch.analysis.reanalyze import reanalyze
from repro_torch.analysis.top_ops import top_ops
from repro_torch.bridge import params_from_jax
from repro_torch.config import ShapeConfig, reduced_config
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch import steps as TS
from repro_torch.models import model as TM
from repro_torch.optim import adamw_init

ARCHS = ("yi-9b", "gemma3-12b", "deepseek-v2-236b")
B, S = 2, 64
FLOP_RTOL = 0.01


def _cfgs(arch, **kw):
    return (dataclasses.replace(j_reduced(arch), dtype="float32", **kw),
            dataclasses.replace(reduced_config(arch), dtype="float32", **kw))


def _ref_dots(fn, *args) -> float:
    return analyze(jax.jit(fn).lower(*args).compile().as_text()).flops


def _port_dots(fn, *args) -> float:
    rec = OT.OpRecorder(sites="plain")
    with rec:
        fn(*args)
    return OT.totals(rec.records).dot_flops


def _setup(arch, **kw):
    jc, tc = _cfgs(arch, **kw)
    params = JM.init_params(jc, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, params), tc, "cpu")
    toks = np.random.default_rng(0).integers(0, jc.vocab_size,
                                             (B, S)).astype(np.int32)
    return jc, tc, params, model, toks


@pytest.mark.parametrize("arch", ARCHS)
def test_dot_flops_match_the_reference_hlo(arch):
    jc, tc, params, model, toks = _setup(arch)
    local = JM.LOCAL
    want = _ref_dots(lambda p, b: JM.prefill_fn(p, b, jc, local), params,
                     {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got = _port_dots(TM.prefill_fn, model,
                         {"tokens": torch.from_numpy(toks)}, tc)
    assert got == pytest.approx(want, rel=FLOP_RTOL), ("prefill", got, want)
    want = _ref_dots(lambda p, c, t, q: JM.decode_fn(p, c, t, q, jc, local),
                     params, JM.init_caches(jc, B, S),
                     jnp.zeros((B, 1), jnp.int32), jnp.int32(5))
    with torch.no_grad():
        got = _port_dots(TM.decode_fn, model,
                         TM.init_caches(tc, B, S, device="cpu"),
                         torch.zeros((B, 1), dtype=torch.int32),
                         torch.tensor(5, dtype=torch.int32), tc)
    assert got == pytest.approx(want, rel=FLOP_RTOL), ("decode", got, want)


def _train_dots(arch, remat):
    jc, tc, params, model, toks = _setup(arch, remat=remat)
    step, ocfg = JS.build_train_step(jc, JM.LOCAL)
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    ref = _ref_dots(step, params, j_adamw_init(params, ocfg), batch)
    recipe = sh.make_recipe(sh.make_plan(None, tc), tc, ShapeConfig(S, B))
    tstep, tocfg = TS.build_train_step(tc, recipe, device="cpu")
    port = _port_dots(tstep, model,
                      adamw_init(dict(model.named_parameters()), tocfg),
                      {"tokens": toks, "labels": toks})
    return ref, port, tc, model, toks


def test_train_flops_follow_the_remat():
    """The port recomputes each block in the backward (``models/model.py``'s
    per-block checkpoint: the whole forward, less what non-reentrant
    checkpointing can stop before), the reference's "dots" policy saves
    the products without batch dimensions and recomputes at most the
    rest.  With P the blocks' forward products (counted alone,
    ``run_blocks`` in train mode), each count with remat lies above its
    count without and at most P over it:

        port_none < port_dots <= port_none + P,
        ref_none <= ref_dots <= ref_none + P,

    so port_dots / ref_dots lies in [port_none / (ref_none + P),
    (port_none + P) / ref_none].  Without remat the two differ only by
    the products the port's per-chunk cross-entropy checkpoint recomputes
    (the head): at most 5% here.  On the reduced yi-9b (the other
    families' blocks are held to the reference in prefill and decode
    above)."""
    ref_none, port_none, *_ = _train_dots("yi-9b", "none")
    ref_dots, port_dots, tc, model, toks = _train_dots("yi-9b", "dots")
    x = model.embed.table[torch.from_numpy(toks).long()].detach()
    for p in model.parameters():
        p.requires_grad_(True)
    P = _port_dots(TM.run_blocks, model, x,
                   torch.arange(S, dtype=torch.int32), tc, None, "train")
    assert port_none < port_dots <= port_none + P
    assert ref_none <= ref_dots <= ref_none + P
    ratio = port_dots / ref_dots
    assert port_none / (ref_none + P) <= ratio \
        <= (port_none + P) / ref_none, (ratio, port_dots, ref_dots, P)
    assert 1.0 <= port_none / ref_none <= 1.05


def test_collective_wire_bytes_match_their_closed_form():
    """Reduced yi-9b prefill, B=8 S=64 float32, on (data 2, model 2):
    the vocabulary (256 rows) and the heads split over the model axis, the
    batch over the data axis (4 rows a rank), no sequence parallelism at
    this size.  All-reduce 2·(g-1)/g·operand: the lookup's rows, each
    layer's attention and MLP outputs (B_loc, S, D), and greedy sampling's
    value (fp32) and winner (int64) per row.  All-gather (g-1)/g·result:
    each layer's K and V over the model axis (B_loc, S, Hkv, dh) into the
    caches, and the next tokens (B,) int32 over the data axis."""
    cfg = dataclasses.replace(reduced_config("yi-9b"), dtype="float32")
    r = dryrun.run_cell(cfg, ShapeConfig(64, 8, "p", "prefill"), "2x2",
                        None, verbose=False)
    g, bl, D, L = 2, 4, cfg.d_model, cfg.num_layers
    kv = bl * 64 * cfg.num_kv_heads * cfg.resolved_head_dim * 4
    act = bl * 64 * D * 4
    f = (g - 1) / g
    want = {"all-reduce": 2 * f * ((1 + 2 * L) * act + bl * 4 + bl * 8),
            "all-gather": f * (2 * L * kv + 8 * 4)}
    assert r["roofline"]["bytes_by_kind"] == pytest.approx(want, rel=1e-12)
    assert r["collective_count_by_kind"] == {"all-reduce": 1 + 2 * L + 2,
                                             "all-gather": 2 * L + 1}
    assert r["roofline"]["collective_bytes"] == pytest.approx(
        sum(want.values()), rel=1e-12)


def test_kernel_site_costs():
    q = torch.zeros(2, 6, 4, 8)
    k = torch.zeros(2, 6, 2, 8)
    assert OT.attn_pairs(6, 6) == 21
    assert OT.attn_pairs(6, 6, window=2) == 11
    assert OT.attn_pairs(2, 6, q_offset=4) == 11
    assert OT.attn_pairs(3, 5, causal=False) == 15
    c = OT.flash_cost(q, k, k, True, None, 0, None, 32, 32, True)
    assert c == (2 * 16 * 21 * 2 * 4, (2 * 6 * 4 * 8 * 2 + 2 * 6 * 2 * 8 * 2)
                 * 4 + 2 * 6 * 4 * 4, "float32")
    # paged: pages of 4, slot 0 at position 5 on pages (3, 1), slot 1
    # empty; a hole (-1) holds no keys
    qd = torch.zeros(2, 4, 8, dtype=torch.bfloat16)
    pool = torch.zeros(5, 4, 2, 8, dtype=torch.bfloat16)
    pages = torch.tensor([[3, 1, -1], [-1, -1, -1]], dtype=torch.int32)
    cur = torch.tensor([5, 0], dtype=torch.int32)
    c = OT.paged_decode_cost(qd, pool, pool, pages, cur)
    valid = 6
    assert c.flops == 2 * 16 * valid * 4
    assert c.bytes == 2 * 4 * 8 * 2 + valid * 2 * 16 * 2 + 6 * 4 + 2 * 4 \
        + 2 * 4 * 8 * 4 + 2 * 2 * 4 * 4
    assert OT.paged_decode_cost(qd, pool, pool, pages, cur, window=2) \
        .flops == 2 * 16 * 2 * 4
    # on meta every row of the span counts
    m = OT.paged_decode_cost(qd.to("meta"), pool.to("meta"),
                             pool.to("meta"), pages.to("meta"),
                             cur.to("meta"))
    assert m.flops == 2 * 16 * (2 * 12) * 4
    table = torch.zeros(10, 4)
    ids = torch.tensor([[1, 12], [3, 7]])
    c = OT.isp_gather_cost(table, ids, shard_offset=5)
    assert c.bytes == (2 + 4) * 4 * 4 + 4 * 8 and c.flops == 0
    c = OT.isp_gather_pool_cost(table, torch.tensor([5, 5, 6, 99]),
                                torch.tensor([0, 1, 1, 1]), 2,
                                shard_offset=5)
    assert c == (2 * 3 * 4, 4 * 8 * 2 + 2 * 4 * 4 + 2 * 4 * 4, "float32")


def test_a_kernel_site_is_one_record():
    """Under the recorder a kernel entry point is one record with its
    kernel's cost (none of its plain version's ops), on the CPU and on
    ``meta`` (where it builds its outputs and runs nothing); with
    ``sites="plain"`` the plain ops are counted instead.  Outside a
    recorder a ``meta`` tensor still raises."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 8, 4, 16, generator=g)
    k = torch.randn(1, 8, 2, 16, generator=g)
    want = OT.flash_cost(q, k, k)
    for t in (q, q.to("meta")):
        kv = k.to(t.device)
        rec = OT.OpRecorder()
        with rec, torch.no_grad():
            out = ops.flash_attention(t, kv, kv)
        assert out.shape == (1, 8, 4, 16) and out.device == t.device
        (only,) = [r for r in rec.records if r.kind != "view"]
        assert (only.op, only.flops, only.bytes, only.count) == (
            "kernel:flash_attention", want.flops, want.bytes, 1)
    rec = OT.OpRecorder(sites="plain")
    with rec, torch.no_grad():
        ops.flash_attention(q, k, k)
    assert not any(r.kind == "kernel" for r in rec.records)
    assert OT.totals(rec.records).dot_flops > 0
    with pytest.raises(ValueError):
        ops.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))


def test_temp_bytes_track_live_storages():
    """Peak of the storages the recorded code allocates, each freed when
    its last tensor goes; arguments and views add nothing."""
    x = torch.zeros(1000)                      # an argument: 4000 bytes
    rec = OT.OpRecorder()
    with rec:
        a = x * 2                              # +4000
        v = a.view(10, 100)                    # a view: +0
        b = a + 1                              # +4000 -> 8000
        del a, v                               # -4000
        c = b[:500].clone()                    # +2000 -> 6000
        del b, c
        d = torch.empty(3000)                  # +12000 -> 12000
        del d
    assert rec.peak_bytes == 12000 and rec.live_bytes == 0
    ew = OT.totals(rec.records).elementwise_flops
    assert ew == 1000 + 1000 + 500             # mul, add, clone


def test_scatter_bytes_count_the_rows_written():
    """An in-place scatter moves the rows it writes, not its destination:
    ``index_put_`` reads its indices and values and writes the values'
    bytes; ``index_add_`` also reads the rows it adds to."""
    dst = torch.zeros(1000, 8)
    idx = torch.tensor([3, 7])
    vals = torch.ones(2, 8)
    rec = OT.OpRecorder()
    with rec:
        dst.index_put_((idx,), vals)
        dst.index_add_(0, idx, vals)
    got = {r.op: r.bytes for r in rec.records}
    assert got["aten::index_put_"] == 2 * 8 + 64 + 64
    assert got["aten::index_add_"] == 2 * 8 + 64 + 2 * 64


def test_roofline_arithmetic():
    recs = [OT.OpRecord("aten::mm", "dot", "bfloat16", flops=989e12,
                        bytes=1.675e12),
            OT.OpRecord("aten::mm", "dot", "float32", flops=67e12),
            OT.OpRecord("aten::add", "elementwise", "float32",
                        elementwise=33.5e12, bytes=3.35e12, count=2),
            OT.OpRecord("collective:all-reduce", "collective", "bfloat16",
                        bytes=1e9, wire_bytes=450e9, coll_kind="all-reduce",
                        group=16)]
    rf = RF.from_records([r.as_dict() for r in recs], chips=4,
                         model_flops=4 * 989e12)
    assert rf.compute_s == pytest.approx(1 + 1 + 1, rel=1e-12)
    assert rf.memory_s == pytest.approx((1.675e12 + 6.7e12 + 1e9) / 3.35e12,
                                        rel=1e-12)
    assert rf.collective_s == pytest.approx(1.0, rel=1e-12)
    assert rf.dominant == "compute" and rf.step_s == rf.compute_s
    assert rf.dot_flops == 989e12 + 67e12
    assert rf.useful_flops_ratio == pytest.approx(
        4 * 989e12 / (4 * (989e12 + 67e12)), rel=1e-12)
    assert rf.mfu == pytest.approx(1 / 3, rel=1e-12)
    assert rf.bytes_by_kind == {"all-reduce": 450e9}
    assert RF.bound(3.35e9, 0, "bfloat16") == (1.0, "bytes")
    assert RF.bound(0, 989e9, torch.bfloat16) == (1.0, "operations")
    assert RF.bound(0, 495e9, "tf32")[0] == pytest.approx(1.0)
    assert top_ops(recs, "mem", 2) == [(6.7e12, "aten::add", 2),
                                       (1.675e12, "aten::mm", 1)]
    assert top_ops(recs, "coll") == [(450e9, "collective:all-reduce", 1)]
    assert [r[1] for r in top_ops(recs, "flops")] == ["aten::mm"]


def test_reanalyze_reproduces_a_dry_run(tmp_path):
    """A production cell (gemma3-12b x decode_32k on the pod: 48 layers,
    window rings and global strips, cut over 256 ranks) traced once; its
    roofline recomputed from the saved records alone equals the one the
    dry-run wrote."""
    r = dryrun.run_cell("gemma3-12b", "decode_32k", "pod", tmp_path,
                        verbose=False)
    assert r["status"] == "ok" and r["kernel_sites"]["isp_decode"] == 48
    path = tmp_path / "gemma3-12b__decode_32k__pod.json"
    before = json.loads(path.read_text())["roofline"]
    (again,) = reanalyze(tmp_path)
    after = again["roofline"]
    for key in ("compute_s", "memory_s", "collective_s", "step_s", "mfu",
                "dot_flops", "hbm_bytes", "collective_bytes"):
        assert after[key] == pytest.approx(before[key], rel=1e-12), key
    assert after["dominant"] == before["dominant"]
