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
it the reference's tower output. Meshes (the reference's sharded
candidates) go with the multi-GPU slice; the dry-run ``Cell``
(``build_sah_retrieval_cell``) waits for ``launch/cells.py``. Each entry
point runs under ``torch.no_grad()``: the towers' parameters are
trainable, and serving records nothing for autograd.
"""

from __future__ import annotations

import torch

from repro_torch.engine import sharding as eng_sharding
from repro_torch.engine.artifact import IndexArtifact
from repro_torch.engine.config import get_config
from repro_torch.kernels import ops as kops
from repro_torch.models import recsys as rec_lib

N_BITS = 256      # SRP sketch width for serving (W = 8 32-bit words)


@torch.no_grad()
def retrieve_for_user(u: torch.Tensor, cand_vecs: torch.Tensor,
                      cand_codes: torch.Tensor, proj: torch.Tensor,
                      policy=None, *, n_cand: int = 512, k: int = 100):
    """The discrete part of ``sah_retrieve_step`` for one user vector u
    (D,): its SRP code (one ``srp_hash`` launch) and the sketch scan over
    every candidate -> (vals (k,) descending, ids (k,) int32 candidate
    rows)."""
    qcode = kops.srp_hash(u[None, :].contiguous(), proj)          # (1, W)
    n = cand_vecs.shape[0]
    vals, ids = eng_sharding.kmips_flat_arrays(
        cand_vecs, torch.arange(n, dtype=torch.int32, device=u.device),
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
    proj (D, B) f32, the first D rows of the SRP projection (query side).
    Returns (vals (k,), ids (k,) int32)."""
    u = rec_lib.user_tower(model, user_feats, cfg, policy)[0]    # (D,)
    return retrieve_for_user(u, cand_vecs, cand_codes, proj, policy,
                             n_cand=n_cand, k=k)


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
