"""Serving: two-tower retrieval with exact or SAH (sketch) candidate scoring.

Twin of ``src/repro/launch/serve.py`` for one device. The SAH path is the
paper's technique deployed inside the serving stack: candidate item vectors
are indexed offline (``build_candidate_index``: SAT transform + SRP codes
through a kMIPS-only ``IndexArtifact``); online, a query is hashed (d-dim
projection only -- the user transform's appended coordinate is 0) and
candidates are ranked by Hamming distance, the top ``n_cand`` re-ranked
exactly. The scan is the engine's ``engine/sharding.py::
kmips_flat_arrays``, the one the serving stack's ``RetrievalServer`` uses:
one dense ``hamming_scores`` launch, the ``n_cand`` nearest rows, an exact
re-rank and the top k. The exact mode is ``kernels/ops.ip_topk`` over the
candidate vectors.

``sah_retrieve_step`` is split at the user vector: ``retrieve_for_user``
is its discrete part (the query's SRP code, the scan), so a test can feed
it the reference's tower output. Under a mesh policy (every rank makes
the same call) the user tower looks up its row-sharded tables
(``recsys.shard_tables``; a masked take summed over "model") and the
candidate scan shards over its rows (``engine/sharding.py::
kmips_flat_arrays``, ``n_cand`` a shard): one ``srp_hash`` and one dense
``hamming_scores`` a request on every rank.
``build_sah_retrieval_cell``
returns the dry-run ``Cell`` of this path (two-tower-retrieval x
retrieval_cand, variant "sah"; ``launch/cells.py``), under a mesh one
rank's: ``CAND_PAD`` candidates tiled over every axis, the rank holding
only its rows. Each entry point
runs under ``torch.no_grad()``: the towers' parameters are trainable,
and serving records nothing for autograd.
"""

from __future__ import annotations

import torch

from repro_torch.configs import base as cfg_base
from repro_torch.dist.policy import shard_rank
from repro_torch.engine import sharding as eng_sharding
from repro_torch.engine.artifact import IndexArtifact
from repro_torch.engine.config import get_config
from repro_torch.kernels import ops as kops
from repro_torch.launch import cells as cells_lib
from repro_torch.models import recsys as rec_lib

N_BITS = 256      # SRP sketch width for serving (W = 8 32-bit words)
SAH_CELL_CANDIDATES = 1 << 16   # the reference cell's size without a mesh


@torch.no_grad()
def retrieve_for_user(u: torch.Tensor, cand_vecs: torch.Tensor,
                      cand_codes: torch.Tensor, proj: torch.Tensor,
                      policy=None, *, n_cand: int = 512, k: int = 100):
    """The discrete part of ``sah_retrieve_step`` for one user vector u
    (D,): its SRP code (one ``srp_hash`` launch) and the sketch scan over
    every candidate -> (vals (k,) descending, ids (k,) int32 candidate
    rows). Under a mesh the candidates are the rank's equal slice, in mesh
    order, of the whole set (``eng_sharding.rank_rows``)."""
    qcode = kops.srp_hash(u[None, :].contiguous(), proj)          # (1, W)
    n = cand_vecs.shape[0]
    first = n * shard_rank(policy)
    vals, ids = eng_sharding.kmips_flat_arrays(
        cand_vecs, torch.arange(first, first + n, dtype=torch.int32,
                                device=u.device),
        torch.ones(n, dtype=torch.bool, device=u.device), cand_codes, qcode,
        u[None, :], k, policy, n_cand=n_cand)
    return vals[0], ids[0]


@torch.no_grad()
def sah_retrieve_step(model, user_feats: torch.Tensor,
                      cand_vecs: torch.Tensor, cand_codes: torch.Tensor,
                      proj: torch.Tensor, cfg, policy=None, *,
                      n_cand: int = 512, k: int = 100):
    """One query against the candidates via sketch scan + rerank.

    user_feats (1, Fu) int; cand_vecs (N, D) f32; cand_codes (N, W) int32
    bit views of the reference's uint32 codes (``build_candidate_index``);
    proj (D, B) f32, the first D rows of the SRP projection (query side);
    under a mesh the candidates and codes are the rank's rows
    (``retrieve_for_user``).
    Returns (vals (k,), ids (k,) int32)."""
    u = rec_lib.user_tower(model, user_feats, cfg, policy)[0]    # (D,)
    return retrieve_for_user(u, cand_vecs, cand_codes, proj, policy,
                             n_cand=n_cand, k=k)


def build_sah_retrieval_cell(cand_dtype=torch.float32,
                             mesh=None) -> cells_lib.Cell:
    """The dry-run ``Cell`` of the sketch path (``serve.py:56-112``): one
    user's features through ``sah_retrieve_step`` against
    ``SAH_CELL_CANDIDATES`` candidates of ``cand_dtype`` (float32, or
    bfloat16 to halve the re-rank's bytes) with ``N_BITS``-bit codes and
    the (out_dim, N_BITS) query projection. ``materialize`` draws the
    towers and N(0, 1) candidate vectors and indexes them with
    ``build_candidate_index`` (from their float32 values), so the codes
    are the candidates' own. Under ``mesh`` one rank's: ``cells.
    CAND_PAD`` candidates tiled over every mesh axis, the tables
    row-sharded over "model" (``cells.recsys_mesh``), the scan over the
    rank's rows merged across ranks; ``materialize`` draws and indexes
    the whole set and keeps the rank's rows."""
    arch = cfg_base.get("two-tower-retrieval")
    cfg = arch.make_config()
    n, w = SAH_CELL_CANDIDATES, N_BITS // 32
    policy, pad = None, 1
    model = rec_lib.model_for(cfg, cells_lib.META)
    if mesh is not None:
        policy, pad, model = cells_lib.recsys_mesh(arch, cfg, mesh)
        n = cells_lib.CAND_PAD
    init = cells_lib.recsys_fns(arch, cfg, policy, pad)[0]
    axes = tuple(mesh.mesh_dim_names) if mesh is not None else ()
    n_local = n // (policy.device_count if policy is not None else 1)

    def step(model, user_feats, cand_vecs, cand_codes, proj):
        return sah_retrieve_step(model, user_feats, cand_vecs, cand_codes,
                                 proj, cfg, policy)

    def make(dev, gen):
        model = rec_lib.shard_tables(init(gen, dev), policy)
        feats = cells_lib._fields(gen, cfg.user_embedding.vocab_sizes, 1, dev)
        cand = torch.randn(n, cfg.out_dim, generator=gen, device=dev)
        seed = int(torch.randint(2 ** 62, (1,), generator=gen, device=dev))
        codes, proj = build_candidate_index(
            cand, torch.Generator().manual_seed(seed), device=dev)
        if mesh is not None:
            cand, codes = (cells_lib._rows(policy, t, axes)
                           for t in (cand, codes))
        return model, feats, cand.to(cand_dtype), codes, proj

    meta = cells_lib._meta
    abstract = (model,
                meta((1, cfg.user_embedding.n_fields), torch.int32),
                meta((n_local, cfg.out_dim), cand_dtype),
                meta((n_local, w), torch.int32),
                meta((cfg.out_dim, N_BITS), torch.float32))
    where = (f"sharded over the mesh ({n:,} candidates)" if mesh is not None
             else "on one device")
    return cells_lib.Cell(
        "two-tower-retrieval", "retrieval_cand_sah", "retrieval", step,
        abstract, make,
        note=f"paper technique in serving: SAT+SRP sketch scan (hamming "
             f"kernel) + exact rerank, {where}",
        policy=policy if policy is not None else cells_lib.pol.NO_SHARDING)


@torch.no_grad()
def build_candidate_index(item_vecs, generator: torch.Generator | None = None,
                          *, n_bits: int = N_BITS, key=None, kmips_proj=None,
                          device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Offline index build for serving: codes + query-side projection.

    Builds a kMIPS-only ``IndexArtifact`` under the "sah" preset with
    ``n_bits`` (callers that want to ship the index between processes
    should keep the artifact and ``save`` it) and reads its
    ``serving_codes``: ``(codes (N, W) int32, proj_q (D, n_bits))`` with
    ``codes[i]`` the sketch of ``item_vecs[i]`` (input row order), the
    ``cand_codes`` / ``proj`` operands of ``sah_retrieve_step``.
    ``generator``, ``key`` and ``kmips_proj`` are ``IndexArtifact.build``'s
    (the reference draws the projection from ``fold_in(key, 0x5A11)``,
    which torch cannot replay: parity passes it as ``kmips_proj``). Unlike
    the reference's, the last row holds its own code, never the padding's
    (ROADMAP.md queue 3)."""
    art = IndexArtifact.build(
        item_vecs, None, generator,
        config=get_config("sah").replace(n_bits=n_bits), key=key,
        kmips_proj=kmips_proj, device=device)
    return art.serving_codes()
