"""The flagship transformer trained through the port's collective layer
(counterpart of ``mvapich2_tpu/models/transformer.py``), on the virtual
ranks of a ``("dp", "sp", "tp")`` mesh:

  dp: data parallel, gradient sum over "dp" (the allreduce);
  sp: sequence parallel, ring attention (``models/ring_attention.py``);
  tp: tensor parallel, column/row-split matmuls summed over "tp";
  ep: expert parallel, the MoE FFN's tokens sent to their expert's rank
      by an all_to_all over the dp axis.

Where the JAX package runs one shard a device under ``shard_map``, every
tensor here is stacked over the mesh's ranks on dim 0
(``ops/collectives.py``): a parameter of local shape ``s`` is ``[S, *s]``,
the tokens ``[S, B/dp, T/sp]``, the loss ``[S]``. The collectives are the
stock ones of ``ops/collectives.py``, as the JAX package leaves them to
XLA, and so are the local products (``torch.matmul``/``einsum``): the
JAX model computes them outside any Pallas kernel. Autograd differentiates
the stacked program; see ``make_train_step`` for how its gradients equal
the JAX step's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.collectives import all_to_all, allreduce, axis_size
from ..parallel.mesh import Mesh, MeshComm, P, make_mesh, mesh_shape_for
from ..runtime.universe import resolve_device
from .ring_attention import ring_attention

AXES = ("dp", "sp", "tp")


@dataclasses.dataclass(frozen=True)
class Config:
    vocab: int = 256
    d_model: int = 128
    n_heads: int = 8
    n_layers: int = 2
    d_ff: int = 256
    seq_len: int = 128          # global sequence length
    batch: int = 8              # global batch
    n_experts: int = 4          # MoE experts (one layer), split over dp
    moe_layer: int = 1          # the layer whose FFN is the MoE (-1: none)
    dtype: Any = torch.float32
    lr: float = 1e-2


def param_specs(cfg: Config) -> Dict[str, P]:
    """The partition spec of each parameter: tp-split matmuls, experts
    split over dp (ep), everything else replicated."""
    specs = {"emb": P(), "ln_f": P()}
    for i in range(cfg.n_layers):
        L = f"layer_{i}"
        specs[f"{L}/ln1"] = P()
        specs[f"{L}/ln2"] = P()
        specs[f"{L}/wq"] = P(None, "tp")
        specs[f"{L}/wk"] = P(None, "tp")
        specs[f"{L}/wv"] = P(None, "tp")
        specs[f"{L}/wo"] = P("tp", None)
        if i == cfg.moe_layer:
            specs[f"{L}/gate"] = P()
            specs[f"{L}/w1"] = P("dp", None, None)   # experts over ep(=dp)
            specs[f"{L}/w2"] = P("dp", None, None)
        else:
            specs[f"{L}/w1"] = P(None, "tp")
            specs[f"{L}/w2"] = P("tp", None)
    return specs


def init_params(cfg: Config, generator: torch.Generator,
                device=None) -> Dict[str, torch.Tensor]:
    """Global (unsplit) parameters on ``device`` (``None`` is
    ``cuda:0``), drawn from the CPU ``generator``: the JAX
    ``init_params``'s names and shapes, normal weights at scale 0.02 and
    unit layer-norm gains (not the JAX numbers; ``carry.py`` brings
    those across)."""
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    device = resolve_device(device)

    def normal(*shape):
        return (torch.randn(shape, generator=generator, dtype=cfg.dtype)
                * 0.02).to(device)

    def ones(n):
        return torch.ones(n, dtype=cfg.dtype, device=device)
    p = {"emb": normal(cfg.vocab, D), "ln_f": ones(D)}
    for i in range(cfg.n_layers):
        L = f"layer_{i}"
        p[f"{L}/ln1"] = ones(D)
        p[f"{L}/ln2"] = ones(D)
        for w in ("wq", "wk", "wv", "wo"):
            p[f"{L}/{w}"] = normal(D, D)
        if i == cfg.moe_layer:
            p[f"{L}/gate"] = normal(D, E)
            p[f"{L}/w1"] = normal(E, D, F_)
            p[f"{L}/w2"] = normal(E, F_, D)
        else:
            p[f"{L}/w1"] = normal(D, F_)
            p[f"{L}/w2"] = normal(F_, D)
    return p


def _bcast_rows(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A stacked ``[S, *s]`` parameter shaped to broadcast against a
    stacked activation ``[S, ..., *s]``: unit dims after the rank."""
    return w.reshape((w.shape[0],) + (1,) * (x.dim() - w.dim())
                     + tuple(w.shape[1:]))


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Each rank's ``x @ w``: ``[S, ..., d]`` by ``[S, d, e]``."""
    return torch.matmul(x, _bcast_rows(w, x))


def _layernorm(x, g):
    m = x.mean(-1, keepdim=True)
    v = x.var(-1, keepdim=True, correction=0)
    return (x - m) * torch.rsqrt(v + 1e-6) * _bcast_rows(g, x)


def _attention_block(p, L, x, cfg: Config, mesh: Mesh):
    """Ring attention over sp with heads column-split over tp.
    x: ``[S, B, T, D]`` (each rank's batch x sequence block)."""
    S, B, T, D = x.shape
    h = _layernorm(x, p[f"{L}/ln1"])
    Dh = D // cfg.n_heads
    Hl = p[f"{L}/wq"].shape[-1] // Dh        # local heads: H / tp
    q = _mm(h, p[f"{L}/wq"]).reshape(S, B, T, Hl, Dh)
    k = _mm(h, p[f"{L}/wk"]).reshape(S, B, T, Hl, Dh)
    v = _mm(h, p[f"{L}/wv"]).reshape(S, B, T, Hl, Dh)
    attn = ring_attention(q, k, v, MeshComm(mesh, "sp"))
    out = _mm(attn.reshape(S, B, T, Hl * Dh), p[f"{L}/wo"])
    # row-parallel output projection: partial sums reduced over tp
    return x + allreduce(out, MeshComm(mesh, "tp"))


def _gelu(x):
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default form


def _dense_ffn(p, L, x, mesh: Mesh):
    h = _layernorm(x, p[f"{L}/ln2"])
    out = _mm(_gelu(_mm(h, p[f"{L}/w1"])), p[f"{L}/w2"])
    return x + allreduce(out, MeshComm(mesh, "tp"))


def _moe_ffn(p, L, x, cfg: Config, mesh: Mesh):
    """Top-1 MoE with expert parallelism over the dp axis: each token
    goes to its expert's rank by an all_to_all and comes back the same
    way, at a fixed capacity per (rank, local expert)."""
    S, B, T, D = x.shape
    dp = MeshComm(mesh, "dp")
    ep = axis_size(dp)
    E_local = p[f"{L}/w1"].shape[1]          # experts on this rank
    E = E_local * ep
    h = _layernorm(x, p[f"{L}/ln2"])
    tokens = h.reshape(S, -1, D)             # [S, N, D]
    N = tokens.shape[1]
    gate = _mm(tokens, p[f"{L}/gate"])       # [S, N, E]
    expert = torch.argmax(gate, dim=-1)      # the first index on ties
    gate_w = torch.softmax(gate, dim=-1)
    sel_w = torch.gather(gate_w, -1, expert[..., None])[..., 0]

    C = max(1, (2 * N) // E)
    dest_shard = expert // E_local
    # each token's position within its expert's capacity
    onehot = F.one_hot(expert, E).to(torch.int32)
    pos_in_e = torch.cumsum(onehot, dim=1) * onehot
    slot = pos_in_e.sum(-1) - 1              # [S, N]
    keep = slot < C
    le = expert % E_local
    rank = torch.arange(S, device=x.device)[:, None].expand(S, N)
    where = (rank, dest_shard, le, torch.clamp(slot, max=C - 1))
    # the .at[...].add of the JAX model: dropped tokens add zeros to the
    # last slot, so the scatter must accumulate
    buf = torch.zeros((S, ep, E_local, C, D), dtype=tokens.dtype,
                      device=x.device).index_put(
        where, torch.where(keep[..., None], tokens, 0.0), accumulate=True)
    # dispatch: every rank sends its [dest] slab to dest
    recv = all_to_all(buf.reshape(S, ep, -1), dp, split_axis=0,
                      concat_axis=0, tiled=False)
    recv = recv.reshape(S, ep, E_local, C, D)
    # expert compute on the local experts (batched over source ranks)
    hexp = _gelu(torch.einsum("zsecd,zedf->zsecf", recv, p[f"{L}/w1"]))
    yexp = torch.einsum("zsecf,zefd->zsecd", hexp, p[f"{L}/w2"])
    back = all_to_all(yexp.reshape(S, ep, -1), dp, split_axis=0,
                      concat_axis=0, tiled=False)
    back = back.reshape(S, ep, E_local, C, D)
    y = back[where]                          # back into token order
    y = torch.where(keep[..., None], y, 0.0) * sel_w[..., None]
    return x + y.reshape(S, B, T, D)


def forward(params, tokens, cfg: Config, mesh: Mesh):
    """tokens: stacked ``[S, B_local, T_local]`` int (each rank's batch x
    sequence block). Returns logits ``[S, B_local, T_local, vocab]``."""
    S = tokens.shape[0]
    rank = torch.arange(S, device=tokens.device).reshape(S, 1, 1)
    x = params["emb"][rank, tokens.long()]
    for i in range(cfg.n_layers):
        L = f"layer_{i}"
        x = _attention_block(params, L, x, cfg, mesh)
        if i == cfg.moe_layer and f"{L}/gate" in params:
            x = _moe_ffn(params, L, x, cfg, mesh)
        else:
            x = _dense_ffn(params, L, x, mesh)
    x = _layernorm(x, params["ln_f"])
    return _mm(x, params["emb"].transpose(-1, -2))


def loss_fn(params, tokens, cfg: Config, mesh: Mesh) -> torch.Tensor:
    """Next-token loss of each rank's block, averaged over dp and sp:
    stacked ``[S]``, every rank's copy."""
    logits = forward(params, tokens, cfg, mesh)
    targets = torch.roll(tokens.long(), -1, dims=2)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    local = nll[:, :, :-1].mean(dim=(1, 2))
    return allreduce(local, MeshComm(mesh, ("dp", "sp")), "mean")


def _reduce_over(spec: P) -> Tuple[str, ...]:
    """The mesh axes a parameter is replicated on: its gradient sums
    over them."""
    used = {a for part in spec if part
            for a in ((part,) if isinstance(part, str) else part)}
    return tuple(a for a in AXES if a not in used)


def make_train_step(cfg: Config, mesh: Mesh):
    """The training step over the stacked layout: ``step(params,
    tokens) -> (new_params, loss)``, params stacked per
    :func:`param_specs` (:func:`shard_params`), tokens stacked under
    ``P("dp", "sp")``; the loss is rank 0's copy (the JAX step's ``P()``
    output under ``check_vma=False``).

    It takes the loss and its gradients, sums each gradient over the
    axes its parameter is replicated on, and applies SGD. The gradients
    equal the JAX step's: there ``value_and_grad`` runs on every device
    with cotangent 1 for its copy of the loss, and with
    ``check_vma=False`` the transpose of a ``psum`` is a ``psum``.
    Here each rank's copy of the loss gets cotangent 1 too (the
    backward of ``loss.sum()``), and autograd's backward of a group sum
    is the group sum of the cotangents. So, as in JAX, a tp-replicated
    activation's gradient carries the tp fan-in of ``allreduce(out,
    "tp")``, and the ``pmean`` over dp and sp hands cotangent 1 back to
    every rank's local loss. Averaging the stacked loss instead would
    be off by the mesh size."""
    specs = param_specs(cfg)

    def step(params, tokens):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss = loss_fn(leaves, tokens, cfg, mesh)
        grads = torch.autograd.grad(loss.sum(), list(leaves.values()))
        new = {}
        with torch.no_grad():
            for (name, p), g in zip(leaves.items(), grads):
                over = _reduce_over(specs[name])
                if over:
                    g = allreduce(g, MeshComm(mesh, over))
                new[name] = p.detach() - cfg.lr * g
        return new, loss.detach()[0]

    return step


def shard_params(params, cfg: Config, mesh: Mesh):
    """Global parameters -> the stacked layout under their specs."""
    comm = MeshComm(mesh, AXES)
    specs = param_specs(cfg)
    return {k: comm.shard(v, specs[k]).contiguous()
            for k, v in params.items()}


def unshard_params(params, cfg: Config, mesh: Mesh):
    """Stacked parameters -> global ones (each replicated parameter is
    rank 0's copy, as the JAX step's sharded outputs are)."""
    comm = MeshComm(mesh, AXES)
    specs = param_specs(cfg)
    return {k: comm.unshard(v, specs[k]) for k, v in params.items()}


def shard_tokens(tokens, mesh: Mesh) -> torch.Tensor:
    """Global ``[B, T]`` tokens -> stacked under ``P("dp", "sp")``, as
    int32 (the JAX tokens' dtype)."""
    t = torch.as_tensor(tokens).to(torch.int32)
    return MeshComm(mesh, AXES).shard(t, P("dp", "sp")).contiguous()


def default_mesh_shape(n: int) -> Tuple[int, int, int]:
    """The ``(dp, sp, tp)`` shape the JAX ``demo_setup`` picks for ``n``
    devices: sp before tp before dp."""
    if n in (1, 2, 4, 8):
        return {1: (1, 1, 1), 2: (1, 2, 1), 4: (1, 2, 2), 8: (2, 2, 2)}[n]
    a = mesh_shape_for(n, 2)
    return (1, a[0], a[1])


def demo_setup(cfg: Optional[Config] = None,
               mesh_shape: Optional[Tuple[int, int, int]] = None,
               device=None, n: int = 8):
    """``(cfg, mesh, params, tokens, step)`` on ``n`` virtual ranks of
    ``device`` (``None`` is ``cuda:0``): the mesh ``demo_setup`` picks,
    parameters from ``torch.Generator`` seeded 0 and tokens from one
    seeded 1 (the JAX function's keys), both stacked."""
    cfg = cfg or Config()
    mesh_shape = mesh_shape or default_mesh_shape(n)
    mesh = make_mesh(mesh_shape, AXES, device)
    gen = torch.Generator().manual_seed(0)
    params = shard_params(init_params(cfg, gen, mesh.device), cfg, mesh)
    tok_gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq_len),
                           generator=tok_gen, dtype=torch.int64)
    tokens = shard_tokens(tokens.to(mesh.device), mesh)
    return cfg, mesh, params, tokens, make_train_step(cfg, mesh)
