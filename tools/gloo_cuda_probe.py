"""Which collectives gloo runs on CUDA tensors, on this host's torch.

Spawns two ranks on the first card over gloo (as several ranks on one
card run, since NCCL refuses two ranks on one device), calls each
collective ``repro_torch.runtime.collectives`` uses on CUDA tensors, and
prints one JSON line: each collective's outcome ("ok", or the first line
of the error it raised) and whether its result was right.  The port's
collectives call ``torch.distributed`` directly over either backend, so
every collective must read "ok" on a host where several ranks share a
card (all three did on torch 2.11.0+cu128); ``chip_smoke.py``'s sharded
phase runs the same checks through the port's collectives.

    python3 tools/gloo_cuda_probe.py
"""
import json
import os
import socket
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank(rank: int, port: int, out) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    dev = torch.device("cuda", 0)
    x = torch.arange(4.0, device=dev) + 10 * rank

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        return torch.equal(y.cpu(), torch.arange(4.0) * 2 + 10)

    def all_gather():
        parts = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(parts, x)
        return torch.equal(torch.cat(parts).cpu(), torch.cat(
            [torch.arange(4.0), torch.arange(4.0) + 10]))

    def reduce_scatter():
        y = torch.empty(2, device=dev)
        dist.reduce_scatter(y, [x[:2].clone(), x[2:].clone()])
        want = (torch.arange(4.0) * 2 + 10)[2 * rank:2 * rank + 2]
        return torch.equal(y.cpu(), want)

    res = {}
    for name, fn in (("all_reduce", all_reduce), ("all_gather", all_gather),
                     ("reduce_scatter", reduce_scatter)):
        try:
            res[name] = {"outcome": "ok", "right": bool(fn())}
        except Exception as e:             # the probe reports refusals
            res[name] = {"outcome": str(e).splitlines()[0][:160],
                         "right": False}
        dist.barrier()
    if rank == 0:
        out.put(res)
    dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank, args=(r, port, q)) for r in range(2)]
    for p in procs:
        p.start()
    res = q.get(timeout=120)
    for p in procs:
        p.join(timeout=60)
    print(json.dumps({"torch": torch.__version__, "gloo_cuda": res}))
    return 0 if all(p.exitcode == 0 for p in procs) else 1


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.exit(main())
