"""The latent MoE model (``models.latent_moe``), its turn entry point
(``inference.lm``) and expert layer (``ops.moe``) against the plain
reference (``portbench/reference/latent_moe.py``), at a tiny config on the
CPU.

The program runs in fp32 here, as the reference does, so the comparison is
of the algorithm: the two compute the same sums in other orders (batched
products against per-sequence ones, the absorbed decode against the
expanded form), which moves fp32 logits by about 2e-7 of their largest
magnitude.  ``TOL`` (2e-4 of it) leaves 1000 times that and lies far below
what each control moves (0.4 to 0.9 of it): leaving the shared experts
out, choosing experts by the unbiased score, or routing in bf16.
"""

import pytest
import torch

from portbench.reference.latent_moe import (
    LatentMoeReference, layer_spec, make_tensor, tensor_kinds)
from spmm_tpu_torch.configs import LatentMoeConfig
from spmm_tpu_torch.inference import decoding, lm
from spmm_tpu_torch.models.latent_moe import LatentMoe
from spmm_tpu_torch.ops import mla_decode, mla_prefill, moe

CFG = dict(vocab_size=97, hidden_size=64, num_hidden_layers=3,
           num_attention_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
           qk_rope_head_dim=8, v_head_dim=16, intermediate_size=96,
           moe_intermediate_size=32, n_routed_experts=8,
           num_experts_per_tok=2, n_shared_experts=1,
           first_k_dense_replace=1, routed_scaling_factor=2.446,
           rms_norm_eps=1e-5, kv_norm_eps=1e-6, rope_theta=50000.0,
           max_position_embeddings=128, initializer_range=0.02)
SEED = 2 ** 31 + 77
TOL = 2e-4
HISTORY = (5, 13, 9)          # ragged histories of three rows
TURN, ANSWER, POSITIONS = 4, 6, 48


def build(dtype=torch.float32, seed=SEED) -> LatentMoe:
    kinds = tensor_kinds(CFG)
    model = LatentMoe(LatentMoeConfig.from_dict(CFG), dtype)
    model.load_checkpoint(lambda name, shape: make_tensor(
        CFG, seed, name, shape, kinds[name], "cpu"))
    return model.eval()


@pytest.fixture(scope="module")
def model():
    torch.set_num_threads(1)
    return build()


@pytest.fixture(scope="module")
def ref():
    return LatentMoeReference(CFG, SEED, "cpu")


def ids(n, seed):
    return torch.randint(0, CFG["vocab_size"], (n,),
                         generator=torch.Generator().manual_seed(seed))


def close(got, want) -> float:
    """The largest gap over the reference's largest magnitude."""
    return float((got - want).abs().max() / want.abs().max())


def session(model, histories):
    s = lm.SessionCache(model, len(histories), POSITIONS, "cpu")
    lm.prefill_history(model, s, histories)
    return s


def test_full_forward_logits(model, ref):
    seqs = [ids(n, 10 + n) for n in (7, 20, 33)]
    s = lm.SessionCache(model, 3, POSITIONS, "cpu")
    got = lm._prefill(model, s, [(r, 0, x) for r, x in enumerate(seqs)])
    want = torch.cat(ref.logits(seqs, [torch.tensor([len(x) - 1])
                                       for x in seqs]))
    assert close(got, want) < TOL


def decode_logits(model, s, first, tokens):
    """Logits of each decode step, feeding ``tokens`` [B, n] (the
    program's own answers) from the rows' current positions."""
    pos = torch.tensor(s.history) + TURN
    out = []
    for j in range(tokens.shape[1]):
        out.append(model.decode_step(s.cache, tokens[:, j], pos + j,
                                     attention="kernel"))
    return torch.stack(out, 1)


@pytest.mark.parametrize("turns", [1, 2])
def test_prefill_then_decode_against_the_full_forward(model, ref, turns):
    """Ragged histories prefilled once; a turn (then, with ``turns`` 2, a
    second turn that overwrites the first's positions) prefilled and
    decoded through the session cache; every decode step's logits against
    the reference's full forward over history + turn + answers."""
    hist = [ids(n, n) for n in HISTORY]
    s = session(model, hist)
    for t in range(turns):
        turn = torch.stack([ids(TURN, 100 * t + r) for r in range(3)])
        out = lm.answer_turn(model, s, turn, ANSWER)
    ans = torch.as_tensor(out["answers"])
    assert out["steps"] == ANSWER - 1 and ans.shape == (3, ANSWER)
    seqs = [torch.cat([hist[r], turn[r], ans[r, :-1]]) for r in range(3)]
    wanted = [torch.arange(HISTORY[r] + TURN - 1, len(seqs[r]))
              for r in range(3)]
    want = ref.logits(seqs, wanted)
    for r in range(3):
        assert torch.equal(ans[r], want[r].argmax(-1))
    # the decode steps' logits, re-run over the same cache and tokens
    got = decode_logits(model, s, ans[:, 0], ans[:, :-1])
    for r in range(3):
        assert close(got[r], want[r][1:]) < TOL


def test_absorbed_decode_equals_the_expanded_form(model):
    """One token after each history: the decode step (absorbed, through
    kernel 3's plain version) against the prefill of the same token
    (expanded heads)."""
    hist = [ids(n, n) for n in HISTORY]
    nxt = torch.stack([ids(1, 50 + r) for r in range(3)])[:, 0]
    a = session(model, hist)
    b = session(model, hist)
    pos = torch.tensor(HISTORY)
    got = model.decode_step(a.cache, nxt, pos)
    want = lm._prefill(model, b, [(r, HISTORY[r], nxt[r:r + 1])
                                  for r in range(3)])
    assert close(got, want) < TOL
    assert torch.allclose(a.cache, b.cache, atol=1e-6)


def test_mla_plain_version_is_softmax_over_live_positions():
    g = torch.Generator().manual_seed(3)
    q = torch.randn(3, 4, 40, generator=g)
    cache = torch.randn(3, 12, 40, generator=g)
    lens = torch.tensor([1, 7, 12])
    out = mla_decode.mla_decode_attention(q, cache, lens, 32, 0.25)
    for b in range(3):
        s = q[b] @ cache[b, :lens[b]].T * 0.25
        want = torch.softmax(s, -1) @ cache[b, :lens[b], :32]
        assert torch.allclose(out[b], want, atol=1e-6)


def test_router_chooses_by_biased_score_weighs_by_unbiased(ref):
    g = torch.Generator().manual_seed(5)
    x = torch.randn(256, 64, generator=g)
    gate = torch.randn(8, 64, generator=g) * 0.02
    bias = torch.randn(8, generator=g) * 0.05
    idx, w = moe.route(x, gate, bias, 2, 2.446)
    s = torch.sigmoid(x @ gate.T)
    assert torch.equal(idx, (s + bias).topk(2, -1).indices)
    assert not torch.equal(idx, s.topk(2, -1).indices)
    chosen = s.gather(-1, idx)
    assert torch.allclose(w, chosen / chosen.sum(-1, keepdim=True) * 2.446)
    p = "model.layers.1."
    ridx, rw = ref.route(x, {f"{p}mlp.gate.weight": gate,
                             f"{p}mlp.gate.e_score_correction_bias": bias}, p)
    assert torch.equal(idx, ridx) and torch.allclose(w, rw)


def layer_weights(ref, i=1):
    return ref.tensors(layer_spec(CFG, i))


def test_dropless_when_every_token_picks_one_expert(model, ref):
    """The correction bias sends every token to expert 3: no capacity
    drops it, and the layer equals the reference's."""
    layer = model.layers[1]
    w = layer_weights(ref)
    p = "model.layers.1."
    saved = layer.router_bias.clone()
    try:
        layer.router_bias[3] = 10.0
        w[f"{p}mlp.gate.e_score_correction_bias"] = layer.router_bias.clone()
        x = torch.randn(200, 64, generator=torch.Generator().manual_seed(9))
        idx, _ = moe.route(x, layer.router, layer.router_bias, 2, 2.446)
        assert (idx == 3).any(-1).all()
        assert close(layer.ffn(x), ref.moe(x, w, p)) < TOL
    finally:
        layer.router_bias.copy_(saved)


@pytest.mark.parametrize("skew", [False, True])
def test_aligned_layout_holds_every_pair_once(skew):
    """``moe._align`` (the card's dispatch) puts every (token, expert) pair
    in one slot of a block of its expert, and the grouped product over
    that layout, done here in plain torch as the kernel does it, equals
    the plain version."""
    g = torch.Generator().manual_seed(11)
    n, k, e, h, inter, bm = 37, 2, 8, 64, 32, 16
    x = torch.randn(n, h, generator=g)
    idx = torch.stack([torch.randperm(e, generator=g)[:k] for _ in range(n)])
    if skew:
        idx[:, 0] = 5
        idx[:, 1] = torch.where(idx[:, 1] == 5, 0, idx[:, 1])
    w = torch.rand(n, k, generator=g)
    gate_up = torch.randn(e, 2 * inter, h, generator=g) * 0.1
    down = torch.randn(e, h, inter, generator=g) * 0.1
    slot_pair, block_expert = moe._align(idx, e, bm)
    live = slot_pair < n * k
    assert sorted(slot_pair[live].tolist()) == list(range(n * k))
    owner = block_expert.repeat_interleave(bm)
    assert torch.equal(owner[live], idx.reshape(-1)[slot_pair[live]])
    pairs = torch.zeros(n * k, h)
    for blk, ex in enumerate(block_expert.tolist()):
        if ex < 0:
            continue
        sl = slot_pair[blk * bm:(blk + 1) * bm]
        sl = sl[sl < n * k]
        gu = x[sl // k] @ gate_up[ex].T
        act = torch.nn.functional.silu(gu[:, :inter]) * gu[:, inter:]
        pairs[sl] = (act @ down[ex].T) * w.reshape(-1)[sl, None]
    want = moe.routed_experts_reference(x, idx, w, gate_up, down)
    assert torch.allclose(pairs.view(n, k, h).sum(1), want, atol=1e-5)


def test_graph_runner_replays_one_graph_for_every_step(model, monkeypatch):
    """Through the shared runner (``DecodeGraphs`` with its capture and
    replay stubbed, as tests/test_torch_decode_graph.py does), a turn's
    answers equal the eager decode's, from one graph."""
    from tests.test_torch_decode_graph import StubGraphs

    graphs = StubGraphs()
    monkeypatch.setattr(decoding, "_graphs_for", lambda m, dev: graphs)
    hist = [ids(n, n) for n in HISTORY]
    turn = torch.stack([ids(TURN, r) for r in range(3)])
    got = lm.answer_turn(model, session(model, hist), turn, ANSWER)
    want = lm.answer_turn(model, session(model, hist), turn, ANSWER,
                          eager=True)
    assert (got["answers"] == want["answers"]).all()
    stats = graphs.stats()["shapes"][0]
    assert stats["kind"] == "latent" and stats["graphs"] == 1
    assert stats["rows"] == 3 and stats["T"] == POSITIONS


def unbiased_choice(x, gate, bias, k, scale):
    s = torch.sigmoid(torch.nn.functional.linear(x.float(), gate.float()))
    idx = s.topk(k, dim=-1).indices
    w = s.gather(-1, idx)
    return idx, w / (w.sum(-1, keepdim=True) + 1e-20) * scale


def bf16_router(x, gate, bias, k, scale):
    s = torch.sigmoid(torch.nn.functional.linear(
        x.bfloat16(), gate.bfloat16()).float())
    idx = (s + bias).topk(k, dim=-1).indices
    w = s.gather(-1, idx)
    return idx, w / (w.sum(-1, keepdim=True) + 1e-20) * scale


@pytest.mark.parametrize("control", ["no_shared", "unbiased_choice",
                                     "bf16_router"])
def test_controls_break_the_comparison(model, ref, monkeypatch, control):
    """Each control, in the program's place, moves the expert layer's
    output past ``TOL`` over 512 tokens (and the shared experts' absence
    the model's logits too)."""
    layer = model.layers[1]
    w = layer_weights(ref)
    x = torch.randn(512, 64, generator=torch.Generator().manual_seed(13))
    assert close(layer.ffn(x), ref.moe(x, w, "model.layers.1.")) < TOL
    if control == "no_shared":
        for mod in model.layers[1:]:
            monkeypatch.setattr(mod, "shared_down", torch.nn.Parameter(
                torch.zeros_like(mod.shared_down), requires_grad=False))
    else:
        routes = {"unbiased_choice": unbiased_choice,
                  "bf16_router": bf16_router}
        monkeypatch.setattr(moe, "route", routes[control])
    assert close(layer.ffn(x), ref.moe(x, w, "model.layers.1.")) > TOL
    if control == "no_shared":
        seqs = [ids(20, 1)]
        s = lm.SessionCache(model, 1, POSITIONS, "cpu")
        got = lm._prefill(model, s, [(0, 0, seqs[0])])
        want = ref.logits(seqs, [torch.tensor([19])])[0]
        assert close(got, want) > TOL


def test_bf16_witness_rounds_between_fp32_and_fp8(model, ref):
    """The reference in bf16 (the cell's witness of what bf16 rounding
    alone does) moves the logits off the fp32 reference by bf16's rounding
    (above ``TOL``: a witness that rounded nothing would read the fp32
    gaps) and by less than the fp8 control does."""
    seqs = [ids(n, 40 + n) for n in (9, 25)]
    wanted = [torch.arange(len(x)) for x in seqs]
    want = torch.cat(ref.logits(seqs, wanted))
    moved = {p: close(torch.cat(LatentMoeReference(CFG, SEED, "cpu", p)
                                .logits(seqs, wanted)), want)
             for p in ("bf16", "fp8")}
    assert TOL < moved["bf16"] < moved["fp8"]


# ---- the prefill attention's plan (ops/mla_prefill.py), plain Python ----

KEY_BYTES = 16 * 256 * 2      # M's expansion a key: 16 heads x (128 + 128)


def random_segments(n, seed, turn=None):
    """(row, start, count, offset) of ``n`` rows: a turn of ``turn`` tokens
    after histories of 2,048-7,680 (M's), or histories from 0 of 1-7,680
    (set-up's) when ``turn`` is None."""
    g = torch.Generator().manual_seed(seed)
    out, off = [], 0
    for row in torch.randperm(n, generator=g).tolist():
        if turn is None:
            start, count = 0, int(torch.randint(1, 7681, (1,), generator=g))
        else:
            start = int(torch.randint(2048, 7681, (1,), generator=g))
            count = turn
        out.append((row, start, count, off))
        off += count
    return out


PLANS = [(random_segments(128, 1, turn=256), mla_prefill.GROUP_BYTES),
         (random_segments(9, 2), mla_prefill.GROUP_BYTES),
         (random_segments(40, 3, turn=1), 5 * 8192 * KEY_BYTES),
         (random_segments(17, 4, turn=131), 3 * 7000 * KEY_BYTES)]


@pytest.mark.parametrize("segments,budget", PLANS)
def test_prefill_plan_groups_stay_within_the_budget(segments, budget):
    groups = mla_prefill.plan(segments, 16, KEY_BYTES, budget)
    assert sorted(i for g in groups for i in g.segments) == list(
        range(len(segments)))
    for g in groups:
        keys = [segments[i][1] + segments[i][2] for i in g.segments]
        assert g.keys == max(keys) == keys[0]
        assert (len(g.segments) * g.keys * KEY_BYTES <= budget
                or len(g.segments) == 1)
    # longest first, so each group pads its rows little
    firsts = [g.keys for g in groups]
    assert firsts == sorted(firsts, reverse=True)


@pytest.mark.parametrize("segments,budget", PLANS)
def test_prefill_plan_covers_each_query_tile_once(segments, budget):
    groups = mla_prefill.plan(segments, 16, KEY_BYTES, budget)
    seen = []
    for g in groups:
        for slot, row, head, q0, nq, start, off, _ in g.items:
            i = g.segments[slot]
            assert (row, start, off) == (segments[i][0], segments[i][1],
                                         segments[i][3])
            assert 0 < nq <= mla_prefill.BLOCK_Q
            assert q0 % mla_prefill.BLOCK_Q == 0
            seen += [(i, head, q0 + j) for j in range(nq)]
    want = [(i, h, j) for i, (_, _, count, _) in enumerate(segments)
            for h in range(16) for j in range(count)]
    assert sorted(seen) == sorted(want)


@pytest.mark.parametrize("segments,budget", PLANS)
def test_prefill_plan_skips_only_tiles_past_the_diagonal(segments, budget):
    """An item's key tiles (the kernel loops over ``tiles``) are every tile
    holding a key its queries attend; of the segment's other tiles, none
    holds one.  Heads share the tiles, so head 0's items are checked."""
    bk = mla_prefill.BLOCK_K
    for g in mla_prefill.plan(segments, 16, KEY_BYTES, budget):
        for slot, _, head, q0, nq, start, _, tiles in g.items:
            if head:
                continue
            n_keys = start + segments[g.segments[slot]][2]
            n_tiles = -(-n_keys // bk)
            keys = torch.arange(n_tiles * bk)
            pos = start + torch.arange(q0, q0 + nq)
            attends = (keys[None] <= pos[:, None]) & (keys[None] < n_keys)
            attended = attends.view(nq, n_tiles, bk).any(2).any(0)
            assert torch.equal(attended, torch.arange(n_tiles) < tiles)


def test_prefill_plan_tables_on_a_device():
    segments = random_segments(5, 5, turn=7)
    for g in mla_prefill.plan(segments, 16, KEY_BYTES, device="cpu"):
        assert g.table.dtype == torch.int32
        assert g.table.tolist() == [list(it) for it in g.items]
        assert g.rows.tolist() == [segments[i][0] for i in g.segments]


def test_prefill_attention_cpu_runs_the_plain_route():
    """On the CPU the wrapper is the plain version, whatever the plan."""
    g = torch.Generator().manual_seed(7)
    segments = [(1, 3, 5, 0), (0, 0, 4, 5)]
    q = torch.randn(9, 4, 24, generator=g)
    cache = torch.randn(2, 12, 40, generator=g)
    kv_b = torch.randn(4 * 32, 32, generator=g)
    got = mla_prefill.mla_prefill_attention(q, cache, kv_b, segments, 16)
    want = mla_prefill.mla_prefill_attention_reference(q, cache, kv_b,
                                                       segments, 16)
    assert torch.equal(got, want)
    # the second query of row 1 (position 4) against its five keys
    kvb = (cache[1, :5, :32] @ kv_b.T).view(5, 4, 32)
    s = (q[1, :, None, :16] * kvb[None, :, :, :16].transpose(1, 2)).sum(-1)
    s = s[0] + q[1, :, 16:] @ cache[1, :5, 32:].T
    want_row = (torch.softmax(s, -1)[:, :, None]
                * kvb[:, :, 16:].transpose(0, 1)).sum(1)
    assert torch.allclose(got[1].view(4, 16), want_row, atol=1e-5)
