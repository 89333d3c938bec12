"""Tensor parallelism over "model": the hand-written counterpart of what
GSPMD inserts when the reference's plans cut a client's layers over the
"model" axis (``launch.sharding._RULES`` with ``tp_axis="model"``), as
``launch.fsdp`` is for FSDP over "replica".

Megatron's layout, on the dense decoders (qwen3, gemma2, command_r):

* attention: ``w_q`` (and the kv heads its q heads read) column-parallel
  over heads, ``w_o`` row-parallel; the MLP's ``gate`` / ``up``
  column-parallel over d_ff, ``down`` row-parallel;
* the embedding vocab-parallel (a rank holds rows ``[v_lo, v_hi)``), and
  the head with it (the tied embedding's piece, transposed, or the
  untied ``head``'s columns), its cross-entropy vocab-parallel too;
* the norms, and every other leaf the rules leave whole, replicated.

Every TP rank runs the same tokens.  A column-parallel block starts with
``copy`` ("f": the identity forward, its input's gradient all-reduced in
the backward) and a row-parallel one ends with ``reduce`` ("g": the
partial sums all-reduced in the forward, the identity backward), so the
activations between blocks are whole and equal on every rank.  A
replicated leaf that a rank reads only for its own heads (``q_norm``,
``k_norm``) gets a partial gradient: ``replicated`` sums it over "model".
Where the kv heads do not divide the axis (Qwen3 at TP 16, qwen3-smoke at
TP 4) the rules cut ``w_k`` / ``w_v`` along the head dim instead
(``launch.sharding.tp_dims``); ``gather`` then all-gathers them whole,
once a layer, and the rank takes the kv heads its q heads read: the one
whole gather of the slice.

The MoE and MLA families (Mixtral, DeepSeek-V2) cut the same way:

* the experts expert-parallel (``w_gate`` / ``w_up`` / ``w_down``: a rank
  holds experts ``[e_lo, e_hi)`` and combines only the (token, slot)
  pairs routed to them) or, where the experts do not divide the axis
  (Mixtral's 8 on the plan's 16), feature-parallel over each expert's
  d_ff (``launch.sharding.MOE_DFF_FALLBACK``); either way a partial sum,
  reduced.  The router stays replicated and routes every token on every
  rank from the block's input as it is; its gates pass through ``copy``
  (site ``tp_gates``) before the combine, so their gradient, partial on a
  rank, is summed while the aux loss's stays whole (``replicated`` on the
  router would sum that one ``size`` times);
* MLA's ``w_dq`` column-parallel over the q latent, the latent gathered
  whole (``gather_latent``) for ``q_norm``, ``w_uq`` / ``w_ukv`` over
  heads, ``w_o`` row-parallel; ``w_dkv`` and both norms read whole, their
  partial gradients through ``replicated``.

The Mamba-2 mixer (Mamba2-780M, Jamba's mamba layers) cuts over its
heads, with the reference's leaves cut where its rules cut them:

* ``in_proj`` is column-parallel over its ``[z | x | B | C | dt]``
  columns, whose blocks do not fall on those boundaries (a rank's block
  of Mamba2-780M's 6448 columns at TP 2 is z whole and the first 152 x
  channels).  The rank multiplies its block after ``copy``, then
  ``gather_ssm`` all-gathers the blocks whole (activations, not weights)
  with the depthwise conv's ``conv_w`` / ``conv_b``, whose xBC channels
  are cut without regard to heads; the rank takes z, x and dt of its own
  heads and B, C whole.  Their gradient, exact on the rank's channels and
  partial on B, C and the conv's, is summed over "model" and cut back to
  the pieces;
* the SSD scan runs on the rank's heads; ``a_log``, ``dt_bias``,
  ``d_skip`` are read per head, so through ``replicated``;
* the gated RMSNorm runs over the whole d_inner: ``norm`` sums the rows'
  f32 sums of squares over the rank's channels over "model", and the norm
  kernel scales the rank's channels by the whole rows'; backward, the
  rows' sums of g * scale * x are summed the same way, and dx and the
  rank's dscale follow from them (its ``scale`` through ``replicated``);
* ``out_proj`` is row-parallel over d_inner, whose contiguous blocks are a
  rank's heads, and ends in ``reduce``.

The encoder-decoder (Seamless-M4T) and the vision frontend (InternVL2)
cut as the dense decoders do:

* the encoder's blocks (non-causal self-attention with its q / k / v / o
  biases, the gated MLP) are column- and row-parallel as the decoder's;
  ``b_q`` / ``b_k`` / ``b_v`` are cut with their heads, ``b_o`` is added
  once after the reduce, and the encoder's final norm is read whole, so
  the memory it ends in is whole and equal on every rank;
* a decoder block's cross-attention runs the rank's heads: q from the
  normed residual after ``copy``, k and v from the memory with the rank's
  ``w_k`` / ``w_v`` columns, ``w_o`` row-parallel and reduced.  Each rank
  reads the memory for its own heads only, so the memory's gradient is
  partial: ``models.transformer._trunk_inputs`` passes it through
  ``copy`` once, after the encoder, under the site ``tp_memory`` (one
  (b, s_enc, d) all-reduce a client step, whatever the decoder's depth);
* the vision frontend has no weights: its patch embeddings are
  concatenated ahead of the tokens after the vocab-parallel embedding's
  reduce, so every rank holds the same whole activations.

Serving on the serve mesh ("data", "model") runs the same layout
(``launch.serve.serve(mesh=)``): the rank's pieces are ``local_shard``
of the whole tree under ``launch.sharding.serve_param_specs`` (without
FSDP over "data"), and prefill and decode run under
``torch.inference_mode()``, where ``copy`` is the identity and ``reduce``
all-reduces an inference tensor in place.  The rank's cache holds its
kv heads (``models.modules.tp_kv_range``): where the kv heads divide the
axis that is ``local_shard`` of the whole cache under
``serve_cache_specs``; where they do not, the rank holds the kv heads its
q heads read (the reference's spec cuts the head dim there), and so do
its ``w_k`` / ``w_v`` (``launch.serve.serve_pieces``: the weights never
change while serving, so no pass gathers them, ``tp_kv_gather``).  The
encoder-decoder's cross cache holds the rank's kv heads too.  The last
position's logits are the rank's vocab slice; ``gather_logits``
all-gathers the slices whole (site ``tp_logits``) before sampling, so
every rank samples the same token.  Where the heads do not divide the
axis (``attn_tp=False``: InternVL2's 14 at TP 4 or 16) the attention
leaves are whole on every rank and the attention runs whole, with no
``copy`` or ``reduce`` around it (``models.modules.attention_tp``); the
MLP and the vocab stay cut.  The MoE, MLA and Mamba families serve the
training layout too, forward only: the MoE drop-free on the rank's
experts (the gates' ``copy`` sends nothing forward); MLA's absorbed
decode on the rank's heads, its q latent gathered whole
(``tp_latent_gather``) and its latent cache whole on every rank (``w_dkv``
and ``kv_norm`` are whole, so every rank writes the same token latent;
the reference's ``serve_cache_specs`` cuts the latent's rank dim); a
Mamba layer's prefill and decode step on the rank's heads, its in_proj
block gathered with the conv leaves (``tp_ssm_gather``, one token's in a
decode step), the gated norm's row sums all-reduced (``tp_ssm_norm``),
its cache the conv window of its heads' x channels beside B and C whole
and its heads' SSM state.

Each collective is one ``consensus.all_reduce_`` (or, for a gather,
``all_gather_rows``) under a site of its own, so
``consensus.collective_counts()`` reports them: ``tp_forward`` (g, and the
embedding's; in serving every reduction), ``tp_backward`` (f),
``tp_memory`` (f on the encoder-decoder's memory), ``tp_logits`` (the
serving logits' gather), ``tp_gates`` (f on the MoE gates),
``tp_vocab`` (the cross-entropy's max, then its sum of exponentials with
the target logit), ``tp_replicated`` (a replicated leaf's partial
gradient), ``tp_kv_gather`` / ``tp_kv_reduce`` (the fallback's gather and
its gradient's sum), ``tp_latent_gather`` / ``tp_latent_reduce`` (MLA's q
latent, the same two), ``tp_ssm_gather`` / ``tp_ssm_reduce`` (Mamba's
``in_proj`` blocks with the conv leaves, the same two) and
``tp_ssm_norm`` / ``tp_ssm_norm_reduce`` (the gated norm's row sums,
forward and backward).

The model code takes a ``ModelParallel`` through
``models.transformer.ApplyOptions.tp`` and calls only its methods.
"""
from __future__ import annotations

import torch

from repro_torch.core import consensus as cns
from repro_torch.kernels import ops


class ModelParallel:
    """This rank's place on the "model" axis: the ``group`` of its TP
    ranks, its position ``pos`` among them and their number ``size``."""

    def __init__(self, group, pos: int, size: int, attn_tp: bool = True):
        if not 0 <= pos < size:
            raise ValueError(f"position {pos} outside a model axis of {size}")
        self.group, self.pos, self.size = group, int(pos), int(size)
        #: whether the attention runs over the rank's heads (``False``:
        #: whole on every rank, ``serve_param_specs(attn_tp=False)``)
        self.attn_tp = bool(attn_tp)

    @classmethod
    def of(cls, mesh, attn_tp: bool = True) -> "ModelParallel":
        """The model axis of a ``launch.mesh.RankMesh`` (its group made by
        ``group_over``, in the order every rank makes it)."""
        return cls(mesh.group_over(("model",)), mesh.coords()["model"],
                   mesh.shape["model"], attn_tp)

    def __repr__(self) -> str:
        return (f"ModelParallel(pos={self.pos}, size={self.size}, "
                f"attn_tp={self.attn_tp})")

    # -- the four autograd functions ----------------------------------------

    def copy(self, x: torch.Tensor, site: str = "tp_backward"
             ) -> torch.Tensor:
        """f: ``x`` as it is; its gradient summed over "model"."""
        return _Copy.apply(x, self.group, site)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """g: the sum over "model" of the ranks' partial ``x``."""
        return _Reduce.apply(x, self.group)

    def replicated(self, w: torch.Tensor) -> torch.Tensor:
        """A replicated leaf read for this rank's part only: ``w`` as it
        is, its gradient summed over "model" (site ``tp_replicated``)."""
        return _Copy.apply(w, self.group, "tp_replicated")

    def gather(self, pieces, dim: int) -> list:
        """The whole leaves from the ranks' ``pieces``, each cut along
        ``dim``, in one all-gather (site ``tp_kv_gather``); their
        gradients (this rank's part of a sum) summed over "model" in one
        all-reduce (site ``tp_kv_reduce``) and cut back to the pieces."""
        return list(_Gather.apply(dim, self, _KV_SITES, *pieces))

    def gather_latent(self, piece: torch.Tensor) -> torch.Tensor:
        """MLA's q latent whole from the ranks' column pieces ``piece``
        (``(..., q_rank / size)``, ``x @ w_dq``'s piece), as ``gather``
        does for weights (sites ``tp_latent_gather`` / ``tp_latent_reduce``):
        its whole gradient, partial on a rank that reads it for its own
        heads only, summed and cut back to the piece."""
        return _Gather.apply(-1, self, _LATENT_SITES, piece)[0]

    def gather_ssm(self, block: torch.Tensor, conv_w: torch.Tensor,
                   conv_b: torch.Tensor) -> list:
        """Mamba's whole ``x @ in_proj`` (``(b, s, W)``) from the ranks'
        column blocks ``block`` (``(b, s, W / size)``) and the whole conv
        leaves from their pieces, each cut along its last dim, in one
        all-gather (site ``tp_ssm_gather``); their whole gradients,
        partial on a rank that reads its own heads' channels (and B, C and
        the conv's whole), summed in one all-reduce (site
        ``tp_ssm_reduce``) and cut back to the pieces."""
        return list(_Gather.apply(-1, self, _SSM_SITES, block, conv_w,
                                  conv_b))

    def norm(self, piece: torch.Tensor, scale: torch.Tensor,
             eps: float) -> torch.Tensor:
        """RMSNorm over rows whose columns the ranks share: ``piece``
        (``(..., d / size)``) this rank's columns and ``scale`` their
        entries.  The rows' f32 sums of squares over the piece are summed
        over "model" (site ``tp_ssm_norm``, one (...,) vector), and the
        piece is normalised by the whole rows'; backward, the rows' sums
        of g * scale * x the same way (site ``tp_ssm_norm_reduce``)."""
        return _Norm.apply(piece, scale, eps, self)

    # -- the vocab-parallel embedding and cross-entropy ----------------------

    def embed(self, piece: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """The lookup of ``tokens`` in the embedding whose rows
        ``[v_lo, v_hi)`` are ``piece``: ids outside them give zero, then the
        ranks' lookups are summed (site ``tp_forward``)."""
        n = piece.shape[0]
        local = tokens - self.pos * n
        inside = (local >= 0) & (local < n)
        x = piece[local.clamp(0, n - 1)]
        x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype,
                                                          device=x.device))
        return self.reduce(x)

    def gather_logits(self, piece: torch.Tensor) -> torch.Tensor:
        """The whole vocab row from the ranks' slices ``piece`` (``(...,
        V / size)``, the padding masked on global ids), in one all-gather
        (site ``tp_logits``): equal on every rank."""
        return cns.gather_pieces([piece], [piece.dim() - 1], self.group,
                                 site="tp_logits")[0]

    def vocab_lo(self, n_local: int) -> int:
        """The global id of this rank's first vocab row or column."""
        return self.pos * n_local

    def cross_entropy(self, logits: torch.Tensor,
                      targets: torch.Tensor) -> torch.Tensor:
        """Per position, ``logsumexp - target logit`` over the whole vocab
        from this rank's slice ``logits`` (``(..., V / size)``, f32) of it:
        the max, then the sum of exponentials and the target logit, are
        summed over "model" (site ``tp_vocab``, two calls).  The backward is
        local: ``softmax - onehot`` on the slice."""
        return _VocabCE.apply(logits, targets, self)


class _Copy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, site="tp_backward"):
        ctx.group, ctx.site = group, site
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        cns.all_reduce_(g, ctx.group, site=ctx.site)
        return g, None, None


class _Reduce(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        return cns.all_reduce_(y, group, site="tp_forward")

    @staticmethod
    def backward(ctx, g):
        return g, None


#: (gather, reduce) sites of ``_Gather``: the kv fallback's, MLA's latent's
_KV_SITES = ("tp_kv_gather", "tp_kv_reduce")
_LATENT_SITES = ("tp_latent_gather", "tp_latent_reduce")
#: Mamba's: the in_proj blocks with the conv leaves
_SSM_SITES = ("tp_ssm_gather", "tp_ssm_reduce")


class _Gather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, dim: int, mp: ModelParallel, sites, *pieces):
        ctx.mp, ctx.sites = mp, sites
        ctx.dims = [dim % p.dim() for p in pieces]
        ctx.ns = [p.shape[d] for p, d in zip(pieces, ctx.dims)]
        return tuple(cns.gather_pieces(list(pieces), ctx.dims, mp.group,
                                       site=sites[0]))

    @staticmethod
    def backward(ctx, *grads):
        flat = torch.cat([g.reshape(-1) for g in grads])
        cns.all_reduce_(flat, ctx.mp.group, site=ctx.sites[1])
        out, off = [], 0
        for g, d, n in zip(grads, ctx.dims, ctx.ns):
            whole = flat[off:off + g.numel()].view(g.shape)
            off += g.numel()
            out.append(whole.narrow(d, ctx.mp.pos * n, n).contiguous())
        return (None, None, None) + tuple(out)


class _Norm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, eps, mp: ModelParallel):
        lead, dl = x.shape[:-1], x.shape[-1]
        x2 = x.reshape(-1, dl)
        if x2.stride(1) != 1:
            x2 = x2.contiguous()
        ss = ops.rmsnorm_sumsq(x2, scale)
        cns.all_reduce_(ss, mp.group, site="tp_ssm_norm")
        y, rstd = ops.rmsnorm_given(x2, scale, eps, ss, dl * mp.size)
        ctx.mp = mp
        ctx.save_for_backward(x2, scale, rstd)
        return y.reshape(*lead, dl)

    @staticmethod
    def backward(ctx, g):
        x2, scale, rstd = ctx.saved_tensors
        g2 = g.reshape(x2.shape)
        if g2.stride(1) != 1:
            g2 = g2.contiguous()
        dot = ops.rmsnorm_dot(x2, scale, rstd, g2)
        cns.all_reduce_(dot, ctx.mp.group, site="tp_ssm_norm_reduce")
        dx, dscale = ops.rmsnorm_given_bwd(x2, scale, rstd, g2, dot,
                                           x2.shape[1] * ctx.mp.size)
        return dx.reshape(g.shape), dscale, None, None


class _VocabCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, targets, mp: ModelParallel):
        n = logits.shape[-1]
        local = targets - mp.vocab_lo(n)
        inside = (local >= 0) & (local < n)
        local = local.clamp(0, n - 1)
        m = logits.amax(dim=-1).contiguous()
        cns.all_reduce_(m, mp.group, "max", site="tp_vocab")
        s = torch.exp(logits - m[..., None]).sum(dim=-1)
        t = torch.where(inside, torch.gather(logits, -1, local[..., None])
                        [..., 0], torch.zeros((), dtype=logits.dtype,
                                              device=logits.device))
        st = torch.stack([s, t])
        cns.all_reduce_(st, mp.group, site="tp_vocab")
        lse = m + torch.log(st[0])
        ctx.save_for_backward(logits, lse, local, inside)
        return lse - st[1]

    @staticmethod
    def backward(ctx, g):
        logits, lse, local, inside = ctx.saved_tensors
        p = torch.exp(logits - lse[..., None])
        p.scatter_add_(-1, local[..., None],
                       -inside[..., None].to(p.dtype))
        return p * g[..., None], None, None

