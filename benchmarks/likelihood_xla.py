"""Device time and roofline share of the plain-XLA likelihood terms.

The multinomial likelihood's per-evaluation contractions (see
models/multinomial.py) in their plain form, which materializes the N x G
``rfe = exp(psi W^T)``::

    A1[n]    = sum_g Y[n,g] log_rfe[n,g]          log_rfe = psi @ W^T
    A2[n,s]  = sum_g Y[n,g] log_mu[s,g]
    Z[n,sc]  = sum_g rfe[n,g] muL[g,sc]

timed forward and forward+gradient at 100k cells x 5k genes with int8 Y and
S*C = 10, with XLA's default precision. Device time comes from a profiler
trace of the timed window (the union of the device's stream events); the
roofline share divides the least time the card could take (the larger of
bytes over peak bandwidth and FLOPs over peak f32 rate) by it. A large copy
and a large bf16 matrix product are measured in the same process, so the
kernel's share of what the card reaches can be read beside its share of
the data-sheet peaks.

    python benchmarks/likelihood_xla.py [--cells N] [--genes G] [--reps R]

Prints the card and one JSON line. Needs a GPU whose ``device_kind`` is in
PEAKS.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from clonealign_tpu.utils.profiling import gpu_name_and_power_limit  # noqa: E402

# Data-sheet peaks (NVIDIA H100 data sheet, SXM, dense, at the 700 W limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(bytes_per_s=3.35e12, f32_flops=67e12,
                                  bf16_flops=989e12),
}

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def plain_terms(Y, psi, W, log_mu, muL):
    log_rfe = psi @ W.T
    rfe = jnp.exp(log_rfe)
    A1 = jnp.sum(Y * log_rfe, axis=1)
    A2 = Y @ log_mu.T
    Z = rfe @ muL
    return A1, A2, Z


def loss(params, Y):
    a1, a2, z = plain_terms(Y, *params)
    return jnp.sum(a1) + 0.5 * jnp.sum(a2) + jnp.sum(jnp.log(z))


def cost(N, G, K, S, SC):
    """Least bytes and FLOPs the algorithm needs: Y read once per pass
    (int8), and the products' multiply-adds."""
    y_bytes = N * G
    fwd_flops = N * G * (2 * K + 1 + 2 + 2 * S + 2 * SC)
    return dict(fwd=(y_bytes, fwd_flops), fwd_grad=(2 * y_bytes, 3 * fwd_flops))


def device_busy_s(trace_dir: str) -> tuple[float, dict]:
    """Union of the GPU's stream events in the newest trace, in seconds, and
    the event time per line (for a look by hand)."""
    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    streams, others, per_line = [], [], {}
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            events = [(e.start_ns, e.start_ns + e.duration_ns) for e in line.events]
            per_line[f"{plane.name}|{line.name}"] = sum(b - a for a, b in events) / 1e9
            (streams if line.name.startswith("Stream") else others).extend(events)
    intervals = sorted(streams or others)
    busy, end = 0.0, float("-inf")
    for a, b in intervals:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e9, per_line


def timed(fn, args, reps):
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, default=100_000)
    ap.add_argument("--genes", type=int, default=5_000)
    ap.add_argument("--clones", type=int, default=10)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--trace-dir", default=os.path.join(REPO, "chiprun_out",
                                                        "likelihood_trace"))
    args = ap.parse_args(argv)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"likelihood_xla.py: no GPU found (platform {dev.platform!r})")
    smi = "; ".join(gpu_name_and_power_limit())
    print(f"device: {dev.device_kind} count={len(jax.devices())} nvidia-smi: {smi}")

    N, G, C, K, S = args.cells, args.genes, args.clones, 1, 1
    ks = jax.random.split(jax.random.PRNGKey(0), 6)
    Y = jax.random.randint(ks[0], (N, G), 0, 3, jnp.int8)
    params = (
        jax.random.normal(ks[1], (N, K), jnp.float32),
        0.1 * jax.random.normal(ks[2], (G, K), jnp.float32),
        0.3 * jax.random.normal(ks[3], (S, G), jnp.float32),
        jax.random.uniform(ks[4], (G, S * C), jnp.float32, 0.5, 2.0),
    )
    fwd = jax.jit(lambda p, y: plain_terms(y, *p))
    fwd_grad = jax.jit(jax.value_and_grad(loss))
    results = {}
    need = cost(N, G, K, S, S * C)
    peaks = PEAKS.get(dev.device_kind)
    for name, fn in (("fwd", fwd), ("fwd_grad", fwd_grad)):
        wall = timed(fn, (params, Y), args.reps)
        tdir = os.path.join(args.trace_dir, name)
        with jax.profiler.trace(tdir):
            for _ in range(args.reps):
                out = fn(params, Y)
            jax.block_until_ready(out)
        busy, per_line = device_busy_s(tdir)
        dev_s = busy / args.reps
        nbytes, flops = need[name]
        row = dict(wall_ms=wall * 1e3, device_ms=dev_s * 1e3, bytes=nbytes,
                   flops=flops, lines_s=per_line)
        if peaks:
            t_mem = nbytes / peaks["bytes_per_s"]
            t_flop = flops / peaks["f32_flops"]
            row.update(roofline_share=max(t_mem, t_flop) / dev_s if dev_s else None,
                       bound="memory" if t_mem >= t_flop else "f32 compute")
        results[name] = row

    # What the card reaches on a large copy and a large bf16 product.
    x = jnp.ones((1 << 29,), jnp.float32)  # 2 GiB
    copy = jax.jit(lambda v: v + 1.0)
    t = timed(copy, (x,), 10)
    results["copy_GBps"] = 2 * x.nbytes / t / 1e9
    a = jnp.ones((8192, 8192), jnp.bfloat16)
    mm = jax.jit(lambda u, v: u @ v)
    t = timed(mm, (a, a), 10)
    results["bf16_matmul_TFLOPs"] = 2 * 8192**3 / t / 1e12
    print(json.dumps(dict(device_kind=dev.device_kind, nvidia_smi=smi,
                          N=N, G=G, SC=S * C, y_dtype="int8", **results)))
    if peaks is None:
        sys.exit(f"likelihood_xla.py: {dev.device_kind!r} is not in PEAKS")


if __name__ == "__main__":
    main()
