"""The plain reference of GAOT's forward pass, in float32 PyTorch.

Written from GAOT's description (Wen et al., "Geometry Aware Operator
Transformer"; the public camlab-ethz/GAOT code's layer names) with no
kernel, padding, bucket or cache: every graph is an edge list
(:mod:`.graphs`), every neighbourhood reduction an ``index_add``, the
attention an explicit softmax. Parameters are held in a dict under the
original PyTorch GAOT ``state_dict`` names, so the same tensors load into
any implementation that keeps those names.

The model, for coordinates in [-1, 1]^d:

- lifting: a pointwise linear map of the input channels to ``lifting``;
- MAGNO encoder (nodes → latent grid) and decoder (latent grid → nodes):
  per edge (y source, x query) a kernel MLP k(y, x) on [y ‖ x] (GELU between
  layers), cosine attention α(x, y) = softmax over x's neighbours of
  ⟨x/|x|, y/|y|⟩, out(x) = Σ_y α k f(y); beside it the statistical geometric
  embedding of x's neighbourhood (count, mean and variance of the distance,
  centroid offset, covariance eigenvalues; standardised over the queries of
  a sample with the unbiased std, a std under 1e-6 read as 1) through a
  two-layer ReLU MLP, and ``recovery``, a linear map of [out ‖ embedding];
- patchify (patch p, row-major patches), ``patch_linear``, sinusoidal
  absolute positions;
- UViT: pre-RMSNorm blocks (eps 1e-6) of multi-head softmax attention
  (q, k, v, o without bias) and a SwiGLU FFN, the FFN's residual taken from
  the normed stream; long skips from the encoder half into the decoder
  half through ``skip_proj`` on [x ‖ skip];
- unpatchify, the decoder, and ``projection`` to the output channels.

:func:`init_weights` makes the weights from a seed on the device in one
draw. Nothing here imports the measured program.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .graphs import Graph

Params = Dict[str, torch.Tensor]


class Shapes:
    """The sizes of one configuration's model (its ``model`` section)."""

    def __init__(self, model: dict, in_channels: int, out_channels: int):
        args = model["args"]
        magno, tr = args["magno"], args.get("transformer", {})
        self.grid = tuple(model["latent_tokens_size"])
        self.d = magno.get("coord_dim", 2)
        self.radius = magno.get("radius", 0.033)
        self.hidden = magno.get("hidden_size", 64)
        self.mlp_layers = magno.get("mlp_layers", 3)
        self.lift = magno.get("lifting_channels", 32)
        self.max_neighbors = magno.get("max_neighbors")
        self.sampling = magno.get("sampling_strategy")
        self.patch = tr.get("patch_size", 8)
        self.width = tr.get("hidden_size", 256)
        self.layers = tr.get("num_layers", 3)
        attn = tr.get("attn_config", {})
        self.heads = attn.get("num_heads", 8)
        self.ffn = self.width * tr.get("ffn_multiplier", 4)
        self.cin, self.cout = in_channels, out_channels
        self.embed = self.patch ** self.d * self.lift
        for key, want in (("scales", [1.0]), ("use_attention", True),
                          ("attention_type", "cosine"), ("use_geoembed", True),
                          ("embedding_method", "statistical"),
                          ("transform_type", "linear"), ("node_embedding", False),
                          ("use_scale_weights", False), ("neighbor_strategy", "radius")):
            if magno.get(key, want) != want:
                raise ValueError(f"the reference covers magno.{key} = {want!r} only")
        if tr.get("positional_embedding", "absolute") != "absolute" or \
                attn.get("num_kv_heads", self.heads) != self.heads:
            raise ValueError("the reference covers absolute positions and full heads only")
        if self.embed != self.width:
            raise ValueError("the reference covers patch embeddings of the UViT's width")

    @property
    def tokens(self) -> int:
        return int(np.prod([g // self.patch for g in self.grid]))

    def param_shapes(self) -> Dict[str, tuple]:
        """name → shape, in the original GAOT's ``state_dict`` order."""
        h, c, w = self.hidden, self.lift, self.width
        out: Dict[str, tuple] = {}

        def magno(p: str, kernel_in: int):
            sizes = [kernel_in] + [h] * self.mlp_layers + [c]
            for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
                out[f"{p}.agno.channel_mlp.fcs.{i}.weight"] = (b, a)
                out[f"{p}.agno.channel_mlp.fcs.{i}.bias"] = (b,)
            out[f"{p}.geoembed.mlp.0.weight"] = (64, 3 + 2 * self.d)
            out[f"{p}.geoembed.mlp.0.bias"] = (64,)
            out[f"{p}.geoembed.mlp.2.weight"] = (c, 64)
            out[f"{p}.geoembed.mlp.2.bias"] = (c,)
            out[f"{p}.recovery.fcs.0.weight"] = (c, 2 * c, 1)
            out[f"{p}.recovery.fcs.0.bias"] = (c,)

        magno("encoder", 2 * self.d)
        out["encoder.lifting.fcs.0.weight"] = (c, self.cin, 1)
        out["encoder.lifting.fcs.0.bias"] = (c,)
        out["patch_linear.weight"] = (self.embed, self.embed)
        out["patch_linear.bias"] = (self.embed,)
        half = self.layers // 2
        blocks = ([f"processor.encoder_layers.{i}" for i in range(half)]
                  + (["processor.middle_layer"] if self.layers % 2 else [])
                  + [f"processor.decoder_layers.{i}" for i in range(half)])
        for name in blocks:
            if ".decoder_layers." in name:
                out[f"{name}.skip_proj.weight"] = (w, 2 * w)
                out[f"{name}.skip_proj.bias"] = (w,)
            out[f"{name}.attn_norm.weight"] = (w,)
            for proj in ("q", "k", "v", "o"):
                out[f"{name}.attn.{proj}_proj.weight"] = (w, w)
            out[f"{name}.ffn_norm.weight"] = (w,)
            out[f"{name}.ffn.w1.weight"] = (self.ffn, w)
            out[f"{name}.ffn.w3.weight"] = (self.ffn, w)
            out[f"{name}.ffn.w2.weight"] = (w, self.ffn)
        magno("decoder", 2 * self.d)
        out["decoder.projection.fcs.0.weight"] = (self.cout, c, 1)
        out["decoder.projection.fcs.0.bias"] = (self.cout,)
        return out


def init_weights(shapes: Shapes, seed: int, device) -> Params:
    """Weights from ``seed``, drawn on ``device`` in one call: a matrix
    (or 1x1 convolution) normal with std 1/sqrt(fan_in), a bias 0, a norm
    scale 1 (LeCun normal, as Flax's Dense)."""
    spec = shapes.param_shapes()
    mats = {k: s for k, s in spec.items() if len(s) > 1}
    total = sum(int(np.prod(s)) for s in mats.values())
    gen = torch.Generator(device=device).manual_seed(int(seed))
    draw = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for k, s in spec.items():
        if len(s) == 1:
            out[k] = (torch.zeros(s, device=device) if k.endswith(".bias")
                      else torch.ones(s, device=device))
            continue
        n = int(np.prod(s))
        fan_in = s[1] * (s[2] if len(s) == 3 else 1)
        out[k] = draw[at:at + n].view(s) / math.sqrt(fan_in)
        at += n
    return out


def _linear(p: Params, name: str, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
    w = p[f"{name}.weight"]
    if w.dim() == 3:
        w = w[..., 0]
    return F.linear(x, w, p[f"{name}.bias"] if bias else None)


def _kernel_mlp(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    i = 0
    while f"{name}.fcs.{i}.weight" in p:
        if i:
            x = F.gelu(x)
        x = _linear(p, f"{name}.fcs.{i}", x)
        i += 1
    return x


def _segment_softmax(scores: torch.Tensor, dst: torch.Tensor, q: int) -> torch.Tensor:
    mx = torch.full((q,), -torch.inf, dtype=scores.dtype, device=scores.device)
    mx = mx.scatter_reduce(0, dst, scores, reduce="amax", include_self=True)
    ex = torch.exp(scores - mx[dst])
    den = torch.zeros(q, dtype=scores.dtype, device=scores.device).index_add(0, dst, ex)
    return ex / den[dst]


def _statistics(y: torch.Tensor, x: torch.Tensor, g: Graph) -> torch.Tensor:
    """[Q, 3 + 2d] neighbourhood statistics of each query (zeros without
    neighbours)."""
    q, d = x.shape
    diff = y[g.src] - x[g.dst]                                   # [E, d]
    dist2 = (diff * diff).sum(-1)
    dist = torch.sqrt(dist2)
    iu, ju = np.triu_indices(d)
    pairs = torch.stack([diff[:, i] * diff[:, j] for i, j in zip(iu, ju)], -1)
    feat = torch.cat([torch.ones_like(dist)[:, None], dist[:, None], dist2[:, None],
                      diff, pairs], -1)
    sums = torch.zeros(q, feat.shape[1], dtype=feat.dtype, device=feat.device)
    sums = sums.index_add(0, g.dst, feat)
    count = sums[:, 0]
    has = count > 0
    inv = 1.0 / count.clamp(min=1.0)
    mean_d = sums[:, 1] * inv
    var_d = (sums[:, 2] * inv - mean_d * mean_d).clamp(min=0.0)
    delta = sums[:, 3:3 + d] * inv[:, None]
    second = sums[:, 3 + d:] * inv[:, None]
    cov = {}
    for col, (i, j) in enumerate(zip(iu, ju)):
        cov[i, j] = cov[j, i] = second[:, col] - delta[:, i] * delta[:, j]
    if d != 2:
        raise ValueError("the reference's covariance eigenvalues are the 2x2 ones")
    a, b, c = cov[0, 0], cov[0, 1], cov[1, 1]
    half = 0.5 * (a + c)
    disc = torch.sqrt((0.25 * (a - c) ** 2 + b * b).clamp(min=0.0))
    eig = torch.stack([half + disc, half - disc], -1)
    feats = torch.cat([count[:, None], mean_d[:, None], var_d[:, None], delta, eig], -1)
    return torch.where(has[:, None], feats, torch.zeros_like(feats))


def _standardize(f: torch.Tensor) -> torch.Tensor:
    mean = f.mean(0, keepdim=True)
    std = f.std(0, keepdim=True, unbiased=True)
    std = torch.where(std < 1e-6, torch.ones_like(std), std)
    return (f - mean) / std


def magno(p: Params, name: str, y: torch.Tensor, x: torch.Tensor, f: torch.Tensor,
          g: Graph) -> torch.Tensor:
    """One MAGNO side on one graph: sources y [n, d] with features
    f [B, n, c], queries x [q, d]. Returns [B, q, c]."""
    q = x.shape[0]
    ys, xd = y[g.src], x[g.dst]
    kern = _kernel_mlp(p, f"{name}.agno.channel_mlp", torch.cat([ys, xd], -1))
    unit = lambda v: v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp(min=1e-12)
    alpha = _segment_softmax((unit(xd) * unit(ys)).sum(-1), g.dst, q)
    msg = (alpha[:, None] * kern)[None] * f[:, g.src]            # [B, E, c]
    out = torch.zeros(f.shape[0], q, f.shape[2], dtype=f.dtype, device=f.device)
    out = out.index_add(1, g.dst, msg)
    emb = _statistics(y, x, g)
    emb = F.relu(_linear(p, f"{name}.geoembed.mlp.0", _standardize(emb)))
    emb = F.relu(_linear(p, f"{name}.geoembed.mlp.2", emb))
    emb = emb[None].expand(f.shape[0], -1, -1)
    return _linear(p, f"{name}.recovery.fcs.0", torch.cat([out, emb], -1))


def positions(shapes: Shapes) -> torch.Tensor:
    """Sinusoidal absolute embeddings of the patch grid [tokens, width]."""
    counts = [g // shapes.patch for g in shapes.grid]
    mesh = np.meshgrid(*[np.arange(c, dtype=np.float32) for c in counts], indexing="ij")
    pos = np.stack(mesh, -1).reshape(-1, len(counts))
    dim = shapes.embed // (2 * pos.shape[1])
    inv = 1.0 / (10000 ** (np.arange(dim, dtype=np.float32) / dim))
    ang = pos[:, :, None] * inv[None, None]
    emb = np.concatenate([np.sin(ang), np.cos(ang)], -1).reshape(pos.shape[0], -1)
    emb = np.pad(emb, ((0, 0), (0, shapes.embed - emb.shape[1])))
    return torch.from_numpy(emb.astype(np.float32))


def _patchify(x: torch.Tensor, grid, p: int) -> torch.Tensor:
    b, _, c = x.shape
    h, w = grid
    x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def _unpatchify(x: torch.Tensor, grid, p: int, c: int) -> torch.Tensor:
    b = x.shape[0]
    h, w = grid
    x = x.reshape(b, h // p, w // p, p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * w, c)


def _rms(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) * p[f"{name}.weight"]


def _block(p: Params, name: str, x: torch.Tensor, heads: int,
           skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    if skip is not None:
        x = _linear(p, f"{name}.skip_proj", torch.cat([x, skip], -1))
    b, s, w = x.shape
    h = _rms(p, f"{name}.attn_norm", x)
    qkv = [_linear(p, f"{name}.attn.{t}_proj", h, bias=False).view(b, s, heads, -1)
           .transpose(1, 2) for t in ("q", "k", "v")]
    q, k, v = qkv
    att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1]), -1)
    o = (att @ v).transpose(1, 2).reshape(b, s, w)
    x = x + _linear(p, f"{name}.attn.o_proj", o, bias=False)
    x = _rms(p, f"{name}.ffn_norm", x)
    ffn = _linear(p, f"{name}.ffn.w2", F.silu(_linear(p, f"{name}.ffn.w1", x, False))
                  * _linear(p, f"{name}.ffn.w3", x, False), False)
    return x + ffn


def uvit(p: Params, shapes: Shapes, tokens: torch.Tensor) -> torch.Tensor:
    half = shapes.layers // 2
    skips: List[torch.Tensor] = []
    x = tokens
    for i in range(half):
        x = _block(p, f"processor.encoder_layers.{i}", x, shapes.heads)
        skips.append(x)
    if shapes.layers % 2:
        x = _block(p, "processor.middle_layer", x, shapes.heads)
    for i in range(half):
        x = _block(p, f"processor.decoder_layers.{i}", x, shapes.heads, skips.pop())
    return x


def forward(p: Params, shapes: Shapes, latent: torch.Tensor,
            samples: Sequence[tuple], inputs: torch.Tensor) -> torch.Tensor:
    """The model on a batch. ``latent`` [Q, d]; ``samples``: one (coords
    [N, d], encoder graph, decoder graph) for the batch (one point cloud)
    or one per sample; ``inputs`` [B, N, cin]. Returns [B, N, cout]."""
    lifted = _linear(p, "encoder.lifting.fcs.0", inputs)
    if len(samples) == 1:
        coords, enc, dec = samples[0]
        rn = magno(p, "encoder", coords, latent, lifted, enc)
    else:
        rn = torch.cat([magno(p, "encoder", c, latent, lifted[i:i + 1], e)
                        for i, (c, e, _) in enumerate(samples)])
    tok = _linear(p, "patch_linear", _patchify(rn, shapes.grid, shapes.patch))
    tok = tok + positions(shapes).to(tok.device)
    rn = _unpatchify(uvit(p, shapes, tok), shapes.grid, shapes.patch, shapes.lift)
    if len(samples) == 1:
        out = magno(p, "decoder", latent, samples[0][0], rn, samples[0][2])
    else:
        out = torch.cat([magno(p, "decoder", latent, c, rn[i:i + 1], d)
                         for i, (c, _, d) in enumerate(samples)])
    return _linear(p, "decoder.projection.fcs.0", out)
