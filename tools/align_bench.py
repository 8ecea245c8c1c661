"""CUDA alignment kernel vs the XLA form on one GPU, per kernel and end to
end, in one process (so both run on the same card).

    python tools/align_bench.py [--mbp 4] [--targets 8000] [--out FILE]

Per kernel: forward ends for a batch of pairs at (Lq, Lt) in
{(128, 256), (256, 512), (1024, 1024)}, device busy time from a profiler
trace (union of the device's events) and host wall per call. The kernel
runs at its launch width (driver.KERNEL_MAX_PAIRS pairs); the XLA form at
the driver's XLA launch width (CELL_BUDGET cells).

End to end: easy-predict on the synthetic metagenome with each route,
cold run first, then steady runs in turns (kernel, xla, xla, kernel); the
align-stage wall is the time spent in SearchDriver.search. The outputs of
the two routes must be byte-identical; their sha256 digests are printed.
"""

import argparse
import hashlib
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

SUFFIXES = ("fas", "codon.fas", "headersMap.tsv", "gff")
SHAPES = [(128, 256), (256, 512), (1024, 1024)]


def device_busy_seconds(trace_dir):
    """Union of event intervals on the GPU planes of an xplane trace."""
    import jax
    files = sorted(pathlib.Path(trace_dir).rglob("*.xplane.pb"))
    pd = jax.profiler.ProfileData.from_file(str(files[-1]))
    spans = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    spans.sort()
    busy, end = 0.0, -1.0
    for s, e in spans:
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e9


def _time(fn, args, n=5):
    """(device seconds per call, host wall seconds per call)."""
    import jax
    jax.block_until_ready(fn(*args))        # compile + warm
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        walls.append(time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as td:
        with jax.profiler.trace(td):
            for _ in range(n):
                jax.block_until_ready(fn(*args))
        dev = device_busy_seconds(td)
    return dev / n, float(np.median(walls))


def per_kernel():
    import jax
    import jax.numpy as jnp
    from metaeuk_tpu.search import driver as drv
    rng = np.random.default_rng(1)
    rows = []
    for Lq, Lt in SHAPES:
        nq, nt = 512, 2048
        q_mat = jnp.asarray(rng.integers(0, 20, (nq, Lq)), jnp.uint8)
        qb = jnp.asarray(rng.integers(-2, 3, (nq, Lq)), jnp.int8)
        q_lens = jnp.asarray(rng.integers(Lq // 2, Lq + 1, nq), jnp.int32)
        t_mat = jnp.asarray(rng.integers(0, 20, (nt, Lt)), jnp.uint8)
        t_lens = jnp.asarray(rng.integers(Lt // 2, Lt + 1, nt), jnp.int32)
        out = {"Lq": Lq, "Lt": Lt}
        for route in ("kernel", "xla"):
            if route == "kernel":
                B = min(drv.KERNEL_MAX_PAIRS,
                        drv.KERNEL_SCRATCH_BYTES // (8 * Lt))
                prof = drv._seq_profile_jit(q_mat, qb)
                fn = jax.jit(lambda *a: drv._pair_ends_kernel(*a, Lq, Lt))
                args = (prof, q_lens, t_mat, t_lens)
            else:
                B = max(8, min(drv.CELL_BUDGET // (Lq * Lt), 32768))
                fn = jax.jit(lambda *a: drv._pair_ends_xla(*a, Lq, Lt))
                args = (q_mat, qb, q_lens, t_mat, t_lens)
            # pairs grouped by query, as the prefilter emits them
            li = jnp.asarray(np.sort(rng.integers(0, nq, B)), jnp.int32)
            lj = jnp.asarray(rng.integers(0, nt, B), jnp.int32)
            dev_s, wall_s = _time(fn, args + (li, lj))
            real = float(np.sum(np.asarray(q_lens)[np.asarray(li)]
                                * np.asarray(t_lens)[np.asarray(lj)]))
            out[route] = {"pairs": B, "device_s": dev_s, "wall_s": wall_s,
                          "real_cells_per_device_s": real / dev_s}
        out["device_speedup"] = (out["kernel"]["real_cells_per_device_s"]
                                 / out["xla"]["real_cells_per_device_s"])
        rows.append(out)
        print("[kernel] " + json.dumps(out), flush=True)
    return rows


def end_to_end(mbp, targets):
    from metaeuk_tpu.params import Params
    from metaeuk_tpu.pipeline.predict import EasyPredict
    from metaeuk_tpu.search import driver as drv
    from tools.make_metagenome import make_metagenome, write_fasta

    align_s = [0.0]
    search = drv.SearchDriver.search

    def timed_search(self, *a, **k):
        t0 = time.perf_counter()
        try:
            return search(self, *a, **k)
        finally:
            align_s[0] += time.perf_counter() - t0

    drv.SearchDriver.search = timed_search
    route_fn = drv.align_route
    td = pathlib.Path(tempfile.mkdtemp(prefix="align_bench"))
    contigs, proteins = make_metagenome(mbp, targets)
    write_fasta(td / "c.fna", contigs)
    write_fasta(td / "p.faa", proteins)
    res = {"kernel": {"cold": None, "steady": []},
           "xla": {"cold": None, "steady": []}}
    digests = {}

    def run(route, key):
        drv.align_route = (lambda: route) if route == "xla" else route_fn
        align_s[0] = 0.0
        out = td / f"{route}_{key}"
        t0 = time.perf_counter()
        EasyPredict(Params()).run(str(td / "c.fna"), str(td / "p.faa"),
                                  str(out))
        wall = time.perf_counter() - t0
        rec = {"wall_s": wall, "align_s": align_s[0]}
        if key == "cold":
            res[route]["cold"] = rec
        else:
            res[route]["steady"].append(rec)
        digests[route] = {s: hashlib.sha256(
            pathlib.Path(f"{out}.{s}").read_bytes()).hexdigest()
            for s in SUFFIXES}
        print(f"[e2e] {route} {key}: " + json.dumps(rec), flush=True)

    run("kernel", "cold")
    run("xla", "cold")
    for route in ("kernel", "xla", "xla", "kernel"):
        run(route, "steady")
    drv.align_route = route_fn
    if digests["kernel"] != digests["xla"]:
        raise AssertionError(f"routes disagree: {digests}")
    return res, {"mbp": mbp, "targets": targets,
                 "contigs": len(contigs), "sha256": digests["kernel"]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mbp", type=float, default=4.0)
    ap.add_argument("--targets", type=int, default=8000)
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-e2e", action="store_true")
    args = ap.parse_args()
    import jax
    from metaeuk_tpu.platform import platform
    if platform() != "gpu":
        raise SystemExit("align_bench measures the GPU; none found")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = jax.devices()[0]
    print(f"card: {smi}; jax {dev.platform} {dev.device_kind}", flush=True)
    result = {"card": smi, "per_kernel": per_kernel()}
    if not args.skip_e2e:
        result["e2e"], result["digests"] = end_to_end(args.mbp,
                                                      args.targets)
    text = json.dumps(result, indent=1)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(text)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
