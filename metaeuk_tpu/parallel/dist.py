"""Multi-chip sharded search step.

A device-mesh replacement for the reference's split/MPI parallelism
(Prefiltering::runSplits / runMpiSplits, lib/mmseqs/src/prefiltering/
Prefiltering.cpp:575-770, and Alignment::run(mpiRank,...),
alignment/Alignment.cpp:219-243): instead of rank-partitioned files and a
master-side merge, the (fragment, target) alignment grid is laid out on a
2D device mesh —

  axis "frags":   fragment batches data-parallel (the contig/query dim)
  axis "targets": the target DB sharded across devices (the memory dim)

Each device aligns its local fragment block against its local target
shard; per-fragment results are combined with an all-gather over the
"targets" axis (rides ICI), after which every device holds the full hit
rows for its fragment block. Host-side E-value filtering then proceeds
exactly as in the single-chip path.
"""

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..data.submat import BLOSUM62_SCORES
from ..ops.sw_jax import sw_batch_ends

FRAGS_AXIS = "frags"
TARGETS_AXIS = "targets"

# per-mesh-axis collective traffic accounting (bytes RECEIVED per device
# over the axis, the ICI-utilization number): an all-gather over an
# n-way axis delivers (n-1)/n of the gathered result to each device.
# Updated analytically at each sharded-step invocation from the static
# shapes — the same arithmetic a profiler would report, available on the
# virtual CPU mesh where no hardware counters exist.
COLLECTIVE_BYTES = {}


def _account(axis, nbytes):
    COLLECTIVE_BYTES[axis] = COLLECTIVE_BYTES.get(axis, 0) + int(nbytes)


def collective_report(reset=False):
    """{axis: bytes} accumulated since the last reset."""
    out = dict(COLLECTIVE_BYTES)
    if reset:
        COLLECTIVE_BYTES.clear()
    return out


def make_mesh(devices=None, frags=None, targets=None):
    """Build the 2D search mesh. Defaults: targets axis = 1 (replicated DB),
    all devices data-parallel over fragments."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if frags is None and targets is None:
        targets = 1
        frags = n
    elif frags is None:
        frags = n // targets
    elif targets is None:
        targets = n // frags
    import numpy as np
    dev_array = np.asarray(devices).reshape(frags, targets)
    return Mesh(dev_array, (FRAGS_AXIS, TARGETS_AXIS))


def sharded_search_step(mesh, Lq, Lt):
    """Returns a jitted step: (q_enc, q_bias, q_len, t_enc, t_len) -> hits.

    Inputs are globally shaped (Bq, Lq) fragments and (Nt, Lt) targets;
    the function shards fragments over FRAGS_AXIS and targets over
    TARGETS_AXIS, aligns the full cross product, and all-gathers the
    per-target-shard results so each fragment row is complete.

    Output: (score, q_end, t_end) arrays of shape (Bq, Nt), sharded over
    FRAGS_AXIS and replicated over TARGETS_AXIS.
    """

    def local_step(q_enc, q_bias, q_len, t_enc, t_len):
        nq = q_enc.shape[0]          # local fragment count
        nt = t_enc.shape[0]          # local target count
        # cross product of local fragments x local targets
        qi = jnp.repeat(jnp.arange(nq), nt)
        ti = jnp.tile(jnp.arange(nt), nq)
        score, q_end, t_end = sw_batch_ends(
            q_enc[qi], q_bias[qi], q_len[qi], t_enc[ti], Lq, Lt,
            t_len=t_len[ti])
        score = score.reshape(nq, nt)
        q_end = q_end.reshape(nq, nt)
        t_end = t_end.reshape(nq, nt)
        # complete each fragment row across the target shards (ICI all-gather)
        score = jax.lax.all_gather(score, TARGETS_AXIS, axis=1, tiled=True)
        q_end = jax.lax.all_gather(q_end, TARGETS_AXIS, axis=1, tiled=True)
        t_end = jax.lax.all_gather(t_end, TARGETS_AXIS, axis=1, tiled=True)
        return score, q_end, t_end

    step = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(P(FRAGS_AXIS, None), P(FRAGS_AXIS, None), P(FRAGS_AXIS),
                  P(TARGETS_AXIS, None), P(TARGETS_AXIS)),
        out_specs=(P(FRAGS_AXIS, None), P(FRAGS_AXIS, None), P(FRAGS_AXIS, None)),
        check_vma=False,
    )
    jitted = jax.jit(step)
    nt_shards = mesh.shape[TARGETS_AXIS]
    nf_shards = mesh.shape[FRAGS_AXIS]

    def wrapped(q_enc, q_bias, q_len, t_enc, t_len):
        # 3 all-gathers of (nq_local, Nt) int32 over the targets axis
        nq_local = -(-q_enc.shape[0] // nf_shards)
        nt_global = t_enc.shape[0]
        per_dev = 3 * nq_local * nt_global * 4
        _account(TARGETS_AXIS,
                 per_dev * (nt_shards - 1) // max(nt_shards, 1))
        return jitted(q_enc, q_bias, q_len, t_enc, t_len)

    return wrapped


def sharded_search_topk_step(mesh, Lq, Lt, k):
    """Bandwidth-efficient variant for large target DBs: each target
    shard reduces its local scores to the per-fragment top-k BEFORE the
    gather, so the ICI collective carries k hits per shard instead of the
    whole shard row (the reference's --max-seqs 300 contract:
    QueryMatcher keeps top max-seqs per query, QueryMatcher.h:206).

    Returns a jitted step -> (score, q_end, t_end, target_idx), each
    (Bq, k), target_idx in GLOBAL target numbering; rows are the exact
    top-k of the dense cross product (score desc, stable in global
    target order for ties within a shard; cross-shard ties resolve by
    shard order via the +shard-offset index tiebreak-free top_k).
    """

    n_target_shards = mesh.shape[TARGETS_AXIS]

    def local_step(q_enc, q_bias, q_len, t_enc, t_len):
        nq = q_enc.shape[0]
        nt = t_enc.shape[0]          # local shard size
        qi = jnp.repeat(jnp.arange(nq), nt)
        ti = jnp.tile(jnp.arange(nt), nq)
        score, q_end, t_end = sw_batch_ends(
            q_enc[qi], q_bias[qi], q_len[qi], t_enc[ti], Lq, Lt,
            t_len=t_len[ti])
        score = score.reshape(nq, nt)
        q_end = q_end.reshape(nq, nt)
        t_end = t_end.reshape(nq, nt)
        k_local = min(k, nt)
        sc_k, idx_k = jax.lax.top_k(score, k_local)
        off = jax.lax.axis_index(TARGETS_AXIS) * nt
        gid_k = idx_k + off
        qe_k = jnp.take_along_axis(q_end, idx_k, axis=1)
        te_k = jnp.take_along_axis(t_end, idx_k, axis=1)
        # gather the per-shard candidate lists (k per shard, not nt)
        sc_all = jax.lax.all_gather(sc_k, TARGETS_AXIS, axis=1, tiled=True)
        gid_all = jax.lax.all_gather(gid_k, TARGETS_AXIS, axis=1, tiled=True)
        qe_all = jax.lax.all_gather(qe_k, TARGETS_AXIS, axis=1, tiled=True)
        te_all = jax.lax.all_gather(te_k, TARGETS_AXIS, axis=1, tiled=True)
        # final reduce to the global top-k
        kk = min(k, k_local * n_target_shards)
        sc_f, sel = jax.lax.top_k(sc_all, kk)
        gid_f = jnp.take_along_axis(gid_all, sel, axis=1)
        qe_f = jnp.take_along_axis(qe_all, sel, axis=1)
        te_f = jnp.take_along_axis(te_all, sel, axis=1)
        return sc_f, qe_f, te_f, gid_f

    step = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(P(FRAGS_AXIS, None), P(FRAGS_AXIS, None), P(FRAGS_AXIS),
                  P(TARGETS_AXIS, None), P(TARGETS_AXIS)),
        out_specs=(P(FRAGS_AXIS, None),) * 4,
        check_vma=False,
    )
    jitted = jax.jit(step)
    nf_shards = mesh.shape[FRAGS_AXIS]

    def wrapped(q_enc, q_bias, q_len, t_enc, t_len):
        # 4 all-gathers of (nq_local, k_local) int32 per shard — the
        # whole point of this variant: traffic scales with k, not Nt
        nq_local = -(-q_enc.shape[0] // nf_shards)
        k_local = min(k, -(-t_enc.shape[0] // n_target_shards))
        per_dev = 4 * nq_local * k_local * n_target_shards * 4
        _account(TARGETS_AXIS,
                 per_dev * (n_target_shards - 1) // max(n_target_shards, 1))
        return jitted(q_enc, q_bias, q_len, t_enc, t_len)

    return wrapped
