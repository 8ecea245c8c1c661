"""Multi-process easy-predict worker (the reference's MPI-rank role).

Launched once per process with a shared coordinator; initializes
jax.distributed, runs this process's contig partition through
parallel.multihost.distributed_easy_predict, and lets rank 0 merge the
partition outputs (Prefiltering::runMpiSplits / Alignment::run(mpiRank)
role, lib/mmseqs/src/prefiltering/Prefiltering.cpp:575-770).

    python tools/dist_worker.py <pid> <nprocs> <coord> <contigs> \
        <targets> <out_prefix> [split]

With a split count, the target-split prefilter fans splits over the
processes (parallel/dist_prefilter.py, runMpiSplits role).

Used by tests/test_dist.py::test_two_process_distributed_easy_predict
(CPU backend, gloo collectives). On a GPU host each process sees only its
own card, the one numbered by its process id (CUDA_VISIBLE_DEVICES):
a JAX process reserves most of a card's memory when it starts, so two
processes cannot share one.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main():
    pid, nprocs, coord, contigs, targets, out_prefix = sys.argv[1:7]
    split = int(sys.argv[7]) if len(sys.argv) > 7 else 0
    import os

    cpu = os.environ.get("JAX_PLATFORMS", "") == "cpu"
    if not cpu:
        os.environ.setdefault("CUDA_VISIBLE_DEVICES", pid)
    import jax
    # don't touch jax.devices() or the platform before initialize()
    if cpu:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(coordinator_address=coord,
                               num_processes=int(nprocs),
                               process_id=int(pid))
    from metaeuk_tpu.params import Params
    from metaeuk_tpu.parallel.multihost import distributed_easy_predict

    assert jax.process_count() == int(nprocs), jax.process_count()
    params = Params(split=split) if split else Params()
    distributed_easy_predict(params, contigs, targets, out_prefix)


if __name__ == "__main__":
    main()
