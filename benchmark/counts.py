"""Operations, bytes and bounds of the measured work, and the card's peaks.

The benchmark's own yardstick: every count is the algorithm's, from the
configuration's shapes and the edges of the graphs, never from how an
implementation happens to run it.

- Products: 2·M·N·K a matrix product. The backward of a product counts
  twice its forward; recomputation is not counted.
- Attention: 4·B·H·S²·D forward (QKᵀ and PV), the backward 2.5 times the
  forward; B·H·S² exponentials forward, as many again backward.
- Bytes: each input read once and each output written once. A neighbourhood
  reduce reads its features (each distinct source row once), its per-edge
  coefficients and indices, and writes its output.
- A bound is the largest of operations / peak, bytes / 3.35 TB/s and, for
  attention, exponentials / (16 a clock an SM × 132 SMs × 1.98 GHz).
- Peaks (NVIDIA H100 SXM, dense, 700 W): bf16 989 TFLOP/s; fp32 products
  against the TF32 peak, 495 TFLOP/s, the fastest rate at which the card
  multiplies fp32 inputs in any form (so an exact split-TF32 product cannot
  read above 100%).
"""
from __future__ import annotations

from typing import Dict, NamedTuple

PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 495e12}
PEAK_EXP2 = 16 * 132 * 1.98e9

_SIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def peak_flops(dtype: str) -> float:
    """The product peak a share is taken against, by compute dtype."""
    return PEAK_FLOPS[dtype]


def bound_s(flops: float, nbytes: float, dtype: str, exps: float = 0.0) -> float:
    """The least seconds the card could take."""
    return max(flops / peak_flops(dtype), nbytes / PEAK_BYTES, exps / PEAK_EXP2)


class Work(NamedTuple):
    flops: float
    nbytes: float
    exps: float = 0.0

    def __add__(self, other):
        return Work(self.flops + other.flops, self.nbytes + other.nbytes,
                    self.exps + other.exps)

    def scaled(self, f: float) -> "Work":
        return Work(self.flops * f, self.nbytes * f, self.exps * f)


def matmul(m: int, n: int, k: int, dtype: str) -> Work:
    """[m, k] · [k, n]."""
    s = _SIZE[dtype]
    return Work(2.0 * m * n * k, float(s) * (m * k + k * n + m * n))


def attention_forward(b: int, s: int, h: int, d: int, dtype: str,
                      with_lse: bool = False) -> Work:
    """softmax(QKᵀ/√D)V: Q, K, V read, O (and the LSE) written."""
    size = _SIZE[dtype]
    nbytes = 4.0 * b * s * h * d * size + (4.0 * b * h * s if with_lse else 0.0)
    return Work(4.0 * b * h * s * s * d, nbytes, float(b * h * s * s))


def attention_backward(b: int, s: int, h: int, d: int, dtype: str) -> Work:
    """dQ, dK, dV from Q, K, V, O, dO and the LSE: 2.5 times the forward's
    products, the exponentials again; reads 5 and writes 3 [B, S, H, D]."""
    size = _SIZE[dtype]
    return Work(10.0 * b * h * s * s * d, 8.0 * b * s * h * d * size + 4.0 * b * h * s,
                float(b * h * s * s))


def reduce_forward(b: int, n_src: int, q: int, edges: int, c: int, dtype: str) -> Work:
    """out[b, i] = Σ_e coef[e] · f[b, src_e] over a graph of ``edges``
    edges: f [B, n_src, C] (each distinct row once), coef [E, C] and the
    indices read, out [B, q, C] written."""
    size = _SIZE[dtype]
    return Work(2.0 * b * edges * c,
                size * (b * n_src * c + edges * c + b * q * c) + 4.0 * edges)


def reduce_backward(b: int, n_src: int, q: int, edges: int, c: int, dtype: str):
    """(d_f, d_coef): d_f reads dout, coef and the indices and writes d_f;
    d_coef reads f, dout and the indices and writes d_coef."""
    size = _SIZE[dtype]
    d_f = Work(2.0 * b * edges * c,
               size * (b * q * c + edges * c + b * n_src * c) + 4.0 * edges)
    d_coef = Work(2.0 * b * edges * c,
                  size * (b * n_src * c + b * q * c + edges * c) + 4.0 * edges)
    return d_f, d_coef


class ModelShapes(NamedTuple):
    """What the counts need of a GAOT configuration and a batch."""

    batch: int
    nodes: int             # physical nodes a sample
    latent: int            # latent queries
    cin: int
    cout: int
    lift: int              # MAGNO channels
    hidden: int            # MAGNO MLP width
    mlp_layers: int
    coord_dim: int
    tokens: int
    width: int
    heads: int
    ffn: int
    layers: int
    dtype: str


def uvit_forward(m: ModelShapes) -> Dict[str, Work]:
    """The processor's forward, by part: ``products`` (patch_linear, QKV/O,
    SwiGLU, the long skips) and ``attention``."""
    r, w, dt = m.batch * m.tokens, m.width, m.dtype
    prod = matmul(r, w, w, dt)                                   # patch_linear
    per = matmul(r, w, w, dt).scaled(4) + matmul(r, m.ffn, w, dt).scaled(2) \
        + matmul(r, w, m.ffn, dt)
    prod = prod + per.scaled(m.layers) + matmul(r, w, 2 * w, dt).scaled(m.layers // 2)
    hd = w // m.heads
    return {"products": prod,
            "attention": attention_forward(m.batch, m.tokens, m.heads, hd, dt).scaled(m.layers)}


def magno_forward(m: ModelShapes, enc_edges: int, dec_edges: int,
                  shared_graph: bool) -> Dict[str, Work]:
    """The encoder's and decoder's forward, by part: ``mlps`` (lifting, the
    kernel MLPs over the edges, once for a graph the batch shares, the
    geometric embedding's MLPs, recovery, projection) and ``reduces``.
    ``enc_edges`` and ``dec_edges`` count the batch's edges (a shared
    graph's once)."""
    dt, b, c, h = m.dtype, m.batch, m.lift, m.hidden
    per_graph = 1 if shared_graph else b

    def kernel(edges):
        sizes = [2 * m.coord_dim] + [h] * m.mlp_layers + [c]
        return sum((matmul(edges, o, i, dt) for i, o in zip(sizes[:-1], sizes[1:])),
                   Work(0.0, 0.0))

    def embed(q):
        feats = 3 + 2 * m.coord_dim
        return matmul(q, 64, feats, dt) + matmul(q, c, 64, dt)

    mlps = (matmul(b * m.nodes, c, m.cin, dt)                                # lifting
            + kernel(enc_edges) + kernel(dec_edges)
            + embed(per_graph * m.latent) + embed(per_graph * m.nodes)
            + matmul(b * m.latent, c, 2 * c, dt) + matmul(b * m.nodes, c, 2 * c, dt)
            + matmul(b * m.nodes, m.cout, c, dt))                            # projection
    enc_e = enc_edges if shared_graph else enc_edges // b
    dec_e = dec_edges if shared_graph else dec_edges // b
    if shared_graph:
        reduces = (reduce_forward(b, m.nodes, m.latent, enc_e, c, dt)
                   + reduce_forward(b, m.latent, m.nodes, dec_e, c, dt))
    else:
        reduces = (reduce_forward(1, m.nodes, m.latent, enc_e, c, dt)
                   + reduce_forward(1, m.latent, m.nodes, dec_e, c, dt)).scaled(b)
    return {"mlps": mlps, "reduces": reduces}


def forward_flops(m: ModelShapes, enc_edges: int, dec_edges: int,
                  shared_graph: bool) -> float:
    """The model's forward operations."""
    parts = {**uvit_forward(m), **magno_forward(m, enc_edges, dec_edges, shared_graph)}
    return sum(w.flops for w in parts.values())


def step_flops(m: ModelShapes, enc_edges: int, dec_edges: int,
               shared_graph: bool) -> float:
    """A training step's operations: the forward, twice it for the
    products' backward and 2.5 times it for attention's."""
    u = uvit_forward(m)
    g = magno_forward(m, enc_edges, dec_edges, shared_graph)
    return (3.0 * (u["products"].flops + g["mlps"].flops + g["reduces"].flops)
            + 3.5 * u["attention"].flops)


def attention_step_bound_s(m: ModelShapes) -> float:
    """The least seconds of a step's attention: each layer's forward (with
    the LSE) and backward, each bounded by its own binding term."""
    hd = m.width // m.heads
    fwd = attention_forward(m.batch, m.tokens, m.heads, hd, m.dtype, with_lse=True)
    bwd = attention_backward(m.batch, m.tokens, m.heads, hd, m.dtype)
    return m.layers * (bound_s(*fwd[:2], m.dtype, fwd.exps)
                       + bound_s(*bwd[:2], m.dtype, bwd.exps))


def attention_forward_bound_s(m: ModelShapes) -> float:
    hd = m.width // m.heads
    fwd = attention_forward(m.batch, m.tokens, m.heads, hd, m.dtype)
    return m.layers * bound_s(*fwd[:2], m.dtype, fwd.exps)


def reduce_step_bound_s(m: ModelShapes, enc_edges: int, dec_edges: int,
                        shared_graph: bool, backward: bool = True) -> float:
    """The least seconds of a step's neighbourhood reduces: each reduce's
    forward and (``backward``) its d_f and d_coef, each bounded by its
    bytes or its operations."""
    dt, b, c = m.dtype, m.batch, m.lift
    per = 1 if shared_graph else b
    bb = b if shared_graph else 1
    enc_e, dec_e = (enc_edges, dec_edges) if shared_graph else (enc_edges // b,
                                                                dec_edges // b)
    total = 0.0
    for n_src, q, e in ((m.nodes, m.latent, enc_e), (m.latent, m.nodes, dec_e)):
        calls = (reduce_forward(bb, n_src, q, e, c, dt),)
        if backward:
            calls += reduce_backward(bb, n_src, q, e, c, dt)
        total += per * sum(bound_s(w.flops, w.nbytes, dt) for w in calls)
    return total
