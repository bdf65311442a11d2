"""The frozen yardstick of the per-layer shares: operations and bytes that
the inputs need, and the published peaks of one H100.

Counts are functions of shapes and lengths only, never of the program:

- 2 FLOPs a multiply-add, over matrix products only (linear layers and
  attention's two products), as ``FlopCounterMode`` counts them;
- only needed work: a decode step is one token a beam row (one row a
  molecule at step 0, where the k beams are one), attending its own prefix
  and itself; a text row covers its own length, not its bucket; a property
  step ``i`` of SMILES->PV covers its ``i + 1`` valid positions, not the
  segment's padded 16, 32 or 54; pretraining is forward and backward with
  no recompute.
- a kernel launch's bound is the larger of its bytes over the HBM rate and
  its operations over the peak of the dtype it computes in.  Bytes count
  each input read once and each output written once (the byte counts of
  ``chip_smoke.py``), and of kernel 1's cache one lane a position: the
  ancestry every beam reads covers at least that, so a share can only read
  low, never above 100%.
"""

from __future__ import annotations

# published dense peaks of one H100 SXM (NVIDIA's data sheet), at 700 W
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12}
ESIZE = {"fp32": 4, "bf16": 2, "fp8": 1}


def linear(n_in: int, n_out: int, rows: int) -> float:
    return 2.0 * n_in * n_out * rows


def attention(hidden: int, pairs: int) -> float:
    """q.k and p.v over ``pairs`` (query, key) pairs, all heads."""
    return 4.0 * hidden * pairs


def bert_layer(arch: dict, rows: int, self_pairs: int, cross_rows: int = 0,
               cross_pairs: int = 0) -> float:
    """One layer over ``rows`` positions: q, k, v and output projections,
    self-attention, the cross-attention's q and output projections and
    products (its K/V are ``cross_kv``'s), and the feed-forward."""
    h, i = arch["hidden_size"], arch["intermediate_size"]
    f = 4 * linear(h, h, rows) + attention(h, self_pairs)
    f += linear(h, i, rows) + linear(i, h, rows)
    if cross_rows:
        f += 2 * linear(h, h, cross_rows) + attention(h, cross_pairs)
    return f


def cross_kv(arch: dict, positions: int) -> float:
    """The K and V projections of every cross-attention layer over the
    encoder's ``positions``."""
    n = sum(1 for j in range(arch["num_hidden_layers"])
            if arch["add_cross_attention"] and j >= arch["fusion_layer"])
    return n * 2 * linear(arch["encoder_width"], arch["hidden_size"],
                          positions)


def lm_head(arch: dict, rows: int) -> float:
    h = arch["hidden_size"]
    return linear(h, h, rows) + linear(h, arch["vocab_size"], rows)


def encoder(arch: dict, lengths, layers: range = None) -> float:
    """A bidirectional stack over rows of the given valid lengths."""
    layers = layers or range(arch["num_hidden_layers"])
    rows = sum(lengths)
    pairs = sum(n * n for n in lengths)
    return len(layers) * bert_layer(arch, rows, pairs)


def decode_step(arch: dict, rows: int, pos: int, cross_pairs: int) -> float:
    """One cached decoder step at ``pos`` over ``rows`` beam rows: each
    attends its ``pos`` prefix keys and itself, and the rows together
    ``cross_pairs`` (row, encoder key) pairs in each cross-attention
    layer."""
    f = lm_head(arch, rows)
    for j in range(arch["num_hidden_layers"]):
        cross = arch["add_cross_attention"] and j >= arch["fusion_layer"]
        f += bert_layer(arch, rows, rows * (pos + 1),
                        rows if cross else 0, cross_pairs)
    return f


def beam_decode(arch: dict, m: int, k: int, steps: int,
                cross_keys: int) -> float:
    """``steps`` decoder steps of a k-beam search over m molecules whose
    encoder keys number ``cross_keys`` together (step 0 one row a
    molecule)."""
    f = decode_step(arch, m, 0, cross_keys)
    for pos in range(1, steps):
        f += decode_step(arch, m * k, pos, k * cross_keys)
    return f


def pv_prologue(text: dict, prop: dict, m: int, n_props: int) -> float:
    """PV -> SMILES before the decode: the per-scalar property embedding,
    the property encoder over [CLS] + the properties, and the decoder's
    cross K/V over them."""
    le = n_props + 1
    return (linear(1, prop["hidden_size"], m * n_props)
            + encoder(prop, [le] * m) + cross_kv(text, m * le))


def smiles2pv(text: dict, prop: dict, lengths, n_props: int) -> float:
    """SMILES -> PV of rows with the given text lengths: the text section,
    the cross K/V over it, then each property step i over i + 1 positions
    (the property encoder bidirectional, the fusion layers causal), the MTR
    head on position i and the embedding of its prediction."""
    b, total = len(lengths), sum(lengths)
    h = text["hidden_size"]
    f = encoder(text, lengths, range(text["fusion_layer"]))
    f += cross_kv(text, total)
    fusion = range(text["fusion_layer"], text["num_hidden_layers"])
    for i in range(n_props):
        n = i + 1
        f += encoder(prop, [n] * b)
        f += len(fusion) * bert_layer(text, b * n, b * n * (n + 1) // 2,
                                      b * n, n * total)
        f += linear(h, h, b) + linear(h, 1, b) + linear(1, h, b)
    return f


def rxn_prologue(enc: dict, dec: dict, lengths) -> float:
    """Reaction prediction before the decode: the reactant encoder over the
    sources' valid lengths and the decoder's cross K/V over them."""
    return encoder(enc, lengths) + cross_kv(dec, sum(lengths))


# ---- kernel launches ----

def bound_s(nbytes: float, flops: float, peak: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / peak)


def k1_launch(m: int, k: int, heads: int, head_dim: int, pos: int,
              cache: str) -> tuple[float, float]:
    """(bytes, FLOPs) of one kernel-1 launch at ``pos``: K and V of one
    cache lane a prefix position, the ancestry (an int32 a beam and
    position), q, k_new and v_new read, the context and the appended K and
    V written; q.k and p.v over each beam's prefix and itself."""
    e = ESIZE[cache]
    small = m * heads * k * head_dim * e
    nbytes = 2 * m * pos * heads * head_dim * e + 4 * m * k * pos + 6 * small
    return nbytes, attention(heads * head_dim, m * k * (pos + 1))


def k1_batch_bound_s(m: int, k: int, heads: int, head_dim: int, steps: int,
                     layers: int, cache: str) -> tuple[int, float]:
    """(launches, summed bound seconds) of a decode of ``steps`` steps;
    kernel 1's products run on the CUDA cores in fp32."""
    total = 0.0
    for pos in range(steps):
        total += bound_s(*k1_launch(m, k, heads, head_dim, pos, cache),
                         PEAK_FLOPS["fp32"])
    return steps * layers, layers * total


def k2_launch(heads: int, head_dim: int, q_rows: int, kv_rows: int,
              pairs: int, dtype: str, mask_bytes: int = 0
              ) -> tuple[float, float]:
    """(bytes, FLOPs) of one kernel-2 launch: the needed query rows read
    and written, the needed K and V rows read once, the mask's valid part;
    q.k and p.v over the needed (query, key) pairs."""
    e = ESIZE[dtype]
    hd = heads * head_dim
    nbytes = e * (2 * hd * q_rows + 2 * hd * kv_rows) + mask_bytes
    return nbytes, attention(hd, pairs)


def k2_encoder_bound_s(arch: dict, lengths, layers: int, dtype: str
                       ) -> tuple[int, float]:
    """(launches, summed bound seconds) of kernel 2 in ``layers``
    bidirectional layers over rows of the given valid lengths."""
    rows, pairs = sum(lengths), sum(n * n for n in lengths)
    b = k2_launch(arch["num_attention_heads"], _head_dim(arch), rows, rows,
                  pairs, dtype, 4 * rows)
    return layers, layers * bound_s(*b, PEAK_FLOPS[dtype])


def k2_smiles2pv_bound_s(text: dict, prop: dict, lengths, n_props: int,
                         dtype: str) -> tuple[int, float]:
    """(launches, summed bound seconds) of kernel 2 in SMILES -> PV: the
    text section, then at each property step the property encoder's
    self-attention and the fusion layers' causal self- and
    cross-attention, over the step's i + 1 positions."""
    peak = PEAK_FLOPS[dtype]
    heads, d = text["num_attention_heads"], _head_dim(text)
    b, total = len(lengths), sum(lengths)
    n_text = text["fusion_layer"]
    n_fusion = text["num_hidden_layers"] - n_text
    n_prop = prop["num_hidden_layers"]
    launches, sum_s = k2_encoder_bound_s(text, lengths, n_text, dtype)
    for i in range(n_props):
        n = i + 1
        own = bound_s(*k2_launch(heads, d, b * n, b * n, b * n * n, dtype,
                                 4 * b * n), peak)
        causal = bound_s(*k2_launch(heads, d, b * n, b * n,
                                    b * n * (n + 1) // 2, dtype, 4 * b * n),
                         peak)
        cross = bound_s(*k2_launch(heads, d, b * n, total, n * total, dtype,
                                   4 * total), peak)
        launches += n_prop + 2 * n_fusion
        sum_s += n_prop * own + n_fusion * (causal + cross)
    return launches, sum_s


def _head_dim(arch: dict) -> int:
    return arch["hidden_size"] // arch["num_attention_heads"]
