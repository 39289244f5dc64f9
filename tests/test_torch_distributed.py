"""Multi-process bring-up of the port (``parallel.distributed``): two
localhost processes of 4 virtual CPU shards each, joined by
``initialize_distributed`` over gloo into one global axis of 8 shards,
carry a psum over the 8 shards and a ring shift across the process
boundary.  The counterpart of ``tests/test_distributed.py`` with
``tests/dcn_worker.py``.

The worker is this file: ``python tests/test_torch_distributed.py <rank>
<num_processes> <port>``.  It imports no JAX."""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_LOCAL = 4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# (each process bounded by communicate(timeout=240) below)
def test_two_process_gloo_bringup():
    port = _free_port()
    env = dict(os.environ, PDE_TPU_DEVICE="cpu",
               PDE_TPU_VIRTUAL_DEVICES=str(N_LOCAL))
    for var in ("PDE_TPU_COORDINATOR", "PDE_TPU_NUM_PROCESSES",
                "PDE_TPU_PROCESS_ID"):
        env.pop(var, None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank), "2",
         str(port)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=REPO) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} rc={p.returncode}:\n{out}"
        assert f"DIST OK: rank={rank} procs=2 global_shards=8" in out, out
        assert "ppermute ring verified" in out
        assert "jax" not in out


def _worker(rank: int, nproc: int, port: str) -> int:
    sys.path.insert(0, REPO)
    import torch

    from pde_solver_tpu_torch.parallel import distributed as dist_mod
    from pde_solver_tpu_torch.parallel.shard import Sharded

    # nothing is initialized without a coordinator or a count
    assert dist_mod.initialize_distributed() is False
    dist_mod._INITIALIZED = False
    multi = dist_mod.initialize_distributed(f"localhost:{port}", nproc, rank)
    assert multi and dist_mod.initialize_distributed() is True  # idempotent
    gmesh = dist_mod.global_device_mesh()
    assert gmesh.local.size == N_LOCAL and gmesh.size == N_LOCAL * nproc
    assert gmesh.offset == rank * N_LOCAL and gmesh.world == nproc

    # psum over all 8 shards: 3 entries a shard, each rank + 1
    x = Sharded([torch.full((3,), float(rank + 1), dtype=torch.float64)
                 for _ in range(N_LOCAL)], gmesh.local)
    total = float(dist_mod.psum(x))
    expected = N_LOCAL * 3 * sum(r + 1 for r in range(nproc))
    assert abs(total - expected) < 1e-12, (total, expected)

    # the ring shift: global shard j gets shard j − 1's id, which crosses
    # the process boundary for local shard 0
    ids = Sharded([torch.tensor([float(gmesh.offset + k)])
                   for k in range(N_LOCAL)], gmesh.local)
    got = [float(p[0]) for p in dist_mod.ppermute_ring(ids).parts]
    want = [float((gmesh.offset + k - 1) % gmesh.size)
            for k in range(N_LOCAL)]
    assert got == want, (got, want)
    torch.distributed.destroy_process_group()
    print(f"DIST OK: rank={rank} procs={nproc} global_shards={gmesh.size} "
          f"psum={total} ppermute ring verified; modules "
          f"{sorted(m for m in sys.modules if m.split('.')[0] == 'jax')}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(_worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]))
