"""Multi-host elastic recovery: detect a dead peer, re-dispatch degraded.

Closes the last unimplemented SURVEY §5.3 plan line ("multi-host failure
handling deferred to the runner — re-dispatch on slice failure"): the
process-level driver launches the 2-process DCN workload
(``tools/scaling_dcn.py``'s rung), WATCHES the workers instead of
blocking on them, and on a peer failure — crash, or a hang past the
watchdog (a dead peer leaves the survivor blocked inside a DCN
collective forever) — kills the remaining workers by exact PID and
re-dispatches the same workload single-process. The artifact records the
failure, the detection path, and the degraded-mode result.

CPU-only by design: every worker pins JAX to the CPU. Two JAX processes
cannot share one card (each reserves most of its memory when it starts),
so this two-process drill never touches a GPU.

Fault injection: ``--inject-fault crash`` makes worker 1 abort after
rendezvous + compile (mid-run, the hardest point: the survivor is inside
a collective); ``--inject-fault none`` runs the healthy path.

    python tools/elastic_dcn.py --inject-fault crash \
        --out artifacts/elastic_dcn.json
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import json, os, sys, time
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.environ["ICPSLAM_REPO"])
from jax.sharding import NamedSharding, PartitionSpec as P

from icpslam_tpu.config import IcpConfig
from icpslam_tpu.parallel import dist_step, multihost
from icpslam_tpu.parallel.scaling import _render_pairs

addr, pid = sys.argv[1], int(sys.argv[2])
fault = os.environ.get("ELASTIC_FAULT", "none")
multihost.initialize(coordinator_address=addr, num_processes=2, process_id=pid)
mesh = multihost.global_mesh()
shard = NamedSharding(mesh, P("dp"))

B = 4
batch_a, batch_b = _render_pairs(B, capacity=2048, n_points=1500)

def globalize(batch):
    out = []
    for x in batch:
        x = np.asarray(x)
        lo = pid * (B // 2)
        out.append(jax.make_array_from_process_local_data(
            shard, x[lo : lo + B // 2], x.shape
        ))
    return tuple(out)

ga, gb = globalize(batch_a), globalize(batch_b)
icfg = IcpConfig(mode="plane", max_iterations=5, covariance_knn=8)
step = dist_step.make_batched_step(icfg, mesh)
jax.block_until_ready(step(*ga))  # compile + first collective round
print(f"proc{pid}: WARM", flush=True)

if fault == "crash" and pid == 1:
    # die abruptly MID-RUN: the peer is (or will be) blocked inside a
    # DCN collective with no one on the other end
    os._exit(41)

t0 = time.perf_counter()
for r in range(6):
    out = step(*(ga if r % 2 == 0 else gb))
jax.block_until_ready(out)
dt = (time.perf_counter() - t0) / 6
if pid == 0:
    print("RESULT " + json.dumps({
        "mode": "distributed", "processes": 2,
        "global_devices": len(jax.devices()),
        "step_ms": round(dt * 1000.0, 3),
    }), flush=True)
print(f"proc{pid}: ELASTIC-OK", flush=True)
"""

SINGLE = r"""
import json, os, sys, time
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
import numpy as np

sys.path.insert(0, os.environ["ICPSLAM_REPO"])
from icpslam_tpu.config import IcpConfig
from icpslam_tpu.parallel import dist_step, mesh as mesh_lib
from icpslam_tpu.parallel.scaling import _render_pairs

# degraded re-dispatch: the SAME workload on this process's local devices
# only — no cross-process rendezvous to hang on
mesh = mesh_lib.make_mesh(len(jax.devices()))
B = 4
batch_a, batch_b = _render_pairs(B, capacity=2048, n_points=1500)
shard = mesh_lib.shard_leading(mesh)
pa = tuple(jax.device_put(x[:B], shard) for x in batch_a)
pb = tuple(jax.device_put(x[:B], shard) for x in batch_b)
icfg = IcpConfig(mode="plane", max_iterations=5, covariance_knn=8)
step = dist_step.make_batched_step(icfg, mesh)
jax.block_until_ready(step(*pa))
t0 = time.perf_counter()
for r in range(6):
    out = step(*(pa if r % 2 == 0 else pb))
jax.block_until_ready(out)
dt = (time.perf_counter() - t0) / 6
print("RESULT " + json.dumps({
    "mode": "single_process_degraded",
    "processes": 1,
    "local_devices": len(jax.devices()),
    "step_ms": round(dt * 1000.0, 3),
}), flush=True)
print("SINGLE-OK", flush=True)
"""


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _result_line(out: str):
    lines = [l for l in out.splitlines() if l.startswith("RESULT ")]
    return json.loads(lines[0][len("RESULT "):]) if lines else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--inject-fault", choices=["none", "crash"], default="none")
    ap.add_argument("--out", type=str, default="artifacts/elastic_dcn.json")
    ap.add_argument(
        "--watchdog", type=float, default=120.0,
        help="seconds a worker may run past a peer's death before the "
        "driver declares the slice dead and kills it (survivors hang "
        "inside DCN collectives; only the driver can free them)",
    )
    args = ap.parse_args(argv)

    import tempfile

    tmp = tempfile.mkdtemp(prefix="elastic_")
    worker_py = os.path.join(tmp, "worker.py")
    single_py = os.path.join(tmp, "single.py")
    with open(worker_py, "w") as f:
        f.write(WORKER)
    with open(single_py, "w") as f:
        f.write(SINGLE)
    env = {
        k: v for k, v in os.environ.items()
        if k not in ("JAX_PLATFORMS", "XLA_FLAGS")
    }
    env["ICPSLAM_REPO"] = REPO
    env["ELASTIC_FAULT"] = args.inject_fault

    addr = f"127.0.0.1:{_free_port()}"
    logs = [open(os.path.join(tmp, f"w{i}.log"), "w+") for i in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, worker_py, addr, str(pid)],
            env=env, stdout=logs[pid], stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(2)
    ]

    # --- failure detection: poll exact child PIDs ------------------------
    deadline = time.time() + 900.0
    failure = None
    first_death = None
    while time.time() < deadline:
        codes = [p.poll() for p in procs]
        if all(c is not None for c in codes):
            if any(c != 0 for c in codes):
                failure = f"worker exit codes {codes}"
            break
        dead = [i for i, c in enumerate(codes) if c is not None and c != 0]
        if dead and first_death is None:
            first_death = time.time()
            print(f"detected dead peer(s) {dead} (codes {codes}); "
                  f"watchdog {args.watchdog}s on survivors", file=sys.stderr)
        if first_death is not None and time.time() - first_death > args.watchdog:
            # survivors are stuck in a collective with a dead peer —
            # kill the EXACT PIDs we spawned (never by pattern)
            failure = (
                f"peer(s) {dead} died; survivors hung past "
                f"{args.watchdog}s watchdog"
            )
            for p in procs:
                if p.poll() is None:
                    p.terminate()
            for p in procs:
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()
            break
        time.sleep(0.5)
    else:
        failure = "driver deadline exceeded"
        for p in procs:
            if p.poll() is None:
                p.terminate()

    outs = []
    for lg in logs:
        lg.flush()
        lg.seek(0)
        outs.append(lg.read())
        lg.close()

    artifact = {
        "metric": "elastic_dcn_recovery",
        "inject_fault": args.inject_fault,
        "backend": "cpu (2 OS processes, loopback DCN via jax.distributed)",
    }
    dist_result = _result_line(outs[0])
    if failure is None and dist_result is not None:
        artifact.update(degraded=False, distributed=dist_result)
    else:
        # --- elastic re-dispatch: same workload, single process ----------
        print(f"re-dispatching single-process (reason: {failure})",
              file=sys.stderr)
        t0 = time.time()
        sp = subprocess.run(
            [sys.executable, single_py], env=env, capture_output=True,
            text=True, timeout=900,
        )
        if sp.returncode != 0 or "SINGLE-OK" not in sp.stdout:
            raise RuntimeError(
                f"degraded re-dispatch failed:\n{sp.stdout[-2000:]}\n"
                f"{sp.stderr[-2000:]}"
            )
        artifact.update(
            degraded=True,
            failure=failure,
            detection="driver poll of exact worker PIDs + hang watchdog",
            redispatch=_result_line(sp.stdout),
            redispatch_wall_s=round(time.time() - t0, 1),
        )
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(json.dumps(artifact))
    return 0


if __name__ == "__main__":
    sys.exit(main())
