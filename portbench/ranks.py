"""One process per card: the launcher of a four-card cell, and the helpers
its runner calls.

``launched()`` (``cells.run_cell`` enters it for a cell whose ``chips`` is
above 1) makes the calling process rank 0, starts ranks 1..world-1 as
child processes, and brings the four up as one ``torch.distributed``
group: NCCL with each rank on ``cuda:<rank>``, or gloo on the CPU. The
rendezvous is a ``TCPStore`` that rank 0 opens on a free local port. Each
child gets the ``cfg`` and ``spec`` dicts exactly as rank 0 got them, the
seed, the seconds and the trace flag, holds its threads to 1, runs its
runner's ``follow()``, and exits with 3, naming what it found, if it has
loaded JAX or the JAX package.

A runner of a four-card kind (``traffic/<kind>.py``) has, besides what
every runner has:

  * ``drive()``: on rank 0, with the group already up;
  * ``follow(cell, cfg, spec, seed, seconds, trace, device)``: on ranks 1..;
  * ``control()``: on rank 0 alone, with no group.

Every rank makes the same calls in the same order (the port's SPMD
contract, ``hnsw_tpu_torch/parallel/sharded.py``): rank 0 hands out each
unit of work with ``step(j)``, the followers receive it with ``step()``,
and ``-1`` closes the window, whose end is read from rank 0's clock alone.
``fullest(device)`` gathers every rank's peak device memory and gives the
largest, ``gather(obj)`` any object. ``leave()`` is every rank's last
collective: NCCL tears a group down collectively, so every rank destroys it
at once. A follower leaves when its ``follow()`` returns; ``drive()`` leaves
after its last collective, before the reference runs (else the launch
leaves when the body ends).

Failure never hangs. A child that exits non-zero or is killed, a child
whose NCCL collective times out (its watchdog's line), or a collective of
the harness on rank 0 that waits longer than ``TIMEOUT_S``, fails the run:
the children are killed and rank 0 raises ``RankFailure``
(under NCCL, where a peer's death can leave rank 0 waiting on the card, it
writes the same message and exits with 3 at once). The message ends with
the children's last lines, the failed one's last. Every collective of the
group, the program's own too, times out after ``TIMEOUT_S`` on the
followers and 5 s later on rank 0, so a follower that times out is seen
first. Each child dies with rank 0: the kernel kills it when rank 0 ends
(``PR_SET_PDEATHSIG``), and a watchdog thread ends it if its parent
changes.

    python3 portbench/ranks.py --check [--ranks 4] [--device cuda]

brings four cards up with the harness and the reference alone (no
program) and prints the card names, NCCL's version, the seconds to bring
the group up, the median us of a one-int ``step`` and of an ``all_gather``
of a fan-out search's exchange, and each rank's digest of ``data.make``
for the Deep configuration at 10,000,000 x 96.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import datetime
import importlib
import importlib.util
import inspect
import json
import os
import signal
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# A collective that waits longer than this fails the run. It has to cover
# the longest time one rank can reach a collective after another: the
# first run of a cell, where each rank builds the program's kernels and
# makes its data before the first search's all_gather (seconds apart);
# and a four-card build, where the ranks insert their shards with no
# collective between and end some seconds apart. 120 s is ten times what
# those take, and leaves a failed run 230 s of the 360 s a run may last.
TIMEOUT_S = 120.0
RANK0_EXTRA_S = 5.0       # rank 0 times out after its followers
TAIL_LINES = 40           # a child's last lines kept for the message
POLL_S = 0.1
FORBIDDEN = ("jax", "jaxlib", "flax", "hnsw_tpu")
PR_SET_PDEATHSIG = 1
# a collective that times out takes its process down at once: without the
# debug dump and the wait for it, which held it a minute more
NCCL_ENV = {"TORCH_NCCL_ASYNC_ERROR_HANDLING": "1",
            "TORCH_NCCL_DUMP_ON_TIMEOUT": "0",
            "TORCH_NCCL_TRACE_BUFFER_SIZE": "0",
            "TORCH_NCCL_WAIT_TIMEOUT_DUMP_MILSEC": "1000"}
# what NCCL's watchdog writes when a collective times out: the monitor
# fails the run on it at once, not when the process is taken down
NCCL_TIMEOUT = "Watchdog caught collective operation timeout"

# Test hooks: functions ``fn(setattr)`` run in every follower before
# ``follow()``, to break the timed path on every rank (the fault tests)
PLANTS: list = []


class RankFailure(RuntimeError):
    """A rank failed or stalled; the message ends with the children's last
    lines. ``code`` is the failed child's exit code (None for a stall)."""

    def __init__(self, message: str, code=None, pids=()):
        super().__init__(message)
        self.code, self.pids = code, list(pids)


def loaded_forbidden() -> list[str]:
    """Modules of ``sys.modules`` whose top-level name is one of
    ``FORBIDDEN``, compared whole."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def _dist():
    import torch.distributed as dist
    return dist


def rank() -> int:
    dist = _dist()
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    dist = _dist()
    return dist.get_world_size() if dist.is_initialized() else 1


class _Group:
    """Rank 0's side of one launch: the children, their last lines, and
    the monitor thread that fails the run."""

    def __init__(self, world: int, timeout: float, hard: bool):
        self.world, self.timeout, self.hard = world, timeout, hard
        self.procs: list[subprocess.Popen] = []
        self.tails: list[collections.deque] = []
        self.readers: list[threading.Thread] = []
        self.failure: RankFailure | None = None
        self.busy_since: float | None = None   # rank 0 in a collective
        self.timed_out: int | None = None      # a rank NCCL timed out
        self.lock = threading.Lock()
        self.done = threading.Event()
        self.monitor = threading.Thread(target=self._watch, daemon=True)

    @property
    def pids(self) -> list[int]:
        return [p.pid for p in self.procs]

    def start(self, payload: dict) -> None:
        code = ("import sys; sys.path.insert(0, %r); "
                "from portbench import ranks; sys.exit(ranks._follower())"
                % str(ROOT))
        env = dict(os.environ)
        env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                   OPENBLAS_NUM_THREADS="1", **NCCL_ENV)
        for r in range(1, self.world):
            p = subprocess.Popen(
                [sys.executable, "-c", code], stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                cwd=os.getcwd())
            tail = collections.deque(maxlen=TAIL_LINES)
            reader = threading.Thread(target=self._read,
                                      args=(r, p.stdout, tail), daemon=True)
            reader.start()
            self.procs.append(p)
            self.tails.append(tail)
            self.readers.append(reader)
            p.stdin.write(json.dumps(dict(payload, rank=r)).encode())
            p.stdin.close()
        self.monitor.start()

    def _read(self, r: int, stream, tail) -> None:
        for line in iter(stream.readline, b""):
            line = line.decode(errors="replace").rstrip("\n")
            tail.append(line)
            if NCCL_TIMEOUT in line and self.timed_out is None:
                self.timed_out = r
        stream.close()

    def _watch(self) -> None:
        while not self.done.wait(POLL_S):
            if self.timed_out is not None:
                self.fail(f"a collective timed out on rank {self.timed_out}",
                          self.timed_out, None)
                return
            for r, p in enumerate(self.procs, 1):
                rc = p.poll()
                if rc:
                    self.fail(f"rank {r} exited with code {rc}", r, rc)
                    return
            since = self.busy_since
            if since is not None and time.monotonic() - since > self.timeout:
                self.fail(f"rank 0 waited over {self.timeout:g} s in a "
                          "collective of the harness", None, None)
                return

    def message(self, head: str, failed) -> str:
        """``head`` and every child's last lines, the failed one's last."""
        for t in self.readers:
            t.join(timeout=2.0)
        order = [r for r in range(1, self.world) if r != failed]
        if failed is not None:
            order.append(failed)
        parts = [head]
        for r in order:
            lines = list(self.tails[r - 1]) or ["(nothing)"]
            parts.append(f"--- rank {r}'s last lines:")
            parts.extend(lines)
        return "\n".join(parts)

    def fail(self, head: str, failed, code) -> None:
        with self.lock:
            if self.failure is not None:
                return
            self.kill()
            self.failure = RankFailure(self.message(head, failed), code,
                                       self.pids)
        if self.hard:
            sys.stderr.write(f"portbench: {self.failure}\n")
            sys.stderr.flush()
            os._exit(3)

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            with contextlib.suppress(subprocess.TimeoutExpired):
                p.wait(timeout=5.0)

    def check(self) -> None:
        if self.failure is not None:
            raise self.failure

    def settle(self, seconds: float = 2.0) -> None:
        """After an error on rank 0: a child that ends non-zero within
        ``seconds`` (its death may be what broke rank 0's collective)
        becomes the run's failure."""
        deadline = time.monotonic() + seconds
        while self.failure is None and time.monotonic() < deadline:
            for r, p in enumerate(self.procs, 1):
                rc = p.poll()
                if rc:
                    self.fail(f"rank {r} exited with code {rc}", r, rc)
                    return
            time.sleep(POLL_S)

    def finish(self) -> None:
        """Wait for the children to end by themselves; fail on any that
        does not, or that ends non-zero."""
        deadline = time.monotonic() + self.timeout
        for r, p in enumerate(self.procs, 1):
            try:
                rc = p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                self.fail(f"rank {r} did not end within {self.timeout:g} s "
                          "of rank 0's end", r, None)
                break
            if rc:
                self.fail(f"rank {r} exited with code {rc}", r, rc)
                break
        self.check()

    def close(self) -> None:
        self.done.set()
        self.kill()
        for t in self.readers:
            t.join(timeout=2.0)


_GROUP: _Group | None = None     # rank 0's launch, while it lasts
_DEVICE = None                    # this rank's device, while a group lasts


@contextlib.contextmanager
def _collective():
    """Rank 0's side of a collective of the harness: refused once the run
    has failed, timed by the monitor, and its error turned into the run's
    failure where there is one."""
    g = _GROUP
    if g is None:
        yield
        return
    g.check()
    g.busy_since = time.monotonic()
    try:
        yield
    except Exception as e:
        if g.failure is not None:
            raise g.failure from e
        raise
    finally:
        g.busy_since = None


def step(j: int | None = None) -> int:
    """Rank 0 passes the next unit of work ``j`` (-1 closes the window);
    a follower passes nothing and gets it. A sum over the ranks, not a
    broadcast (which NCCL's root finishes without the others), so rank 0
    waits until every follower has come: a follower that stalls stalls
    rank 0 inside a collective of the harness, where the monitor sees
    it."""
    import torch
    dist = _dist()
    t = torch.tensor([0 if j is None else j], dtype=torch.int64,
                     device=_DEVICE)
    with _collective():
        dist.all_reduce(t)
        return int(t.item())


def gather(obj) -> list:
    """Every rank's ``obj``, in rank order, on every rank."""
    dist = _dist()
    out = [None] * world()
    with _collective():
        dist.all_gather_object(out, obj)
    return out


def fullest(device) -> int:
    """The largest peak device memory over the ranks (``cells.peak``)."""
    from portbench import cells
    return max(gather(cells.peak(device)))


def leave() -> None:
    """Destroy the group, on every rank at the same point."""
    dist = _dist()
    if dist.is_initialized():
        with _collective():
            dist.destroy_process_group()


def _timedelta(seconds: float):
    return datetime.timedelta(seconds=seconds)


def _init(backend: str, store, r: int, n: int, timeout: float, device):
    import torch
    global _DEVICE
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    _dist().init_process_group(backend, store=store, rank=r, world_size=n,
                               timeout=_timedelta(timeout))
    _DEVICE = torch.device(device)


def _plant_refs() -> list:
    return [[inspect.getsourcefile(fn), fn.__name__] for fn in PLANTS]


@contextlib.contextmanager
def launched(cell: str, cfg: dict, spec: dict, seed: int, seconds: float,
             trace: bool, device, world: int, module: str | None = None):
    """Rank 0 of ``world`` ranks for the body: yields its device
    (``cuda:0``, or the CPU). The followers run ``follow()`` of
    ``module`` (a module name), or of the runner of ``spec["kind"]``."""
    import torch
    global _GROUP
    from portbench import traffic
    dev_type = torch.device(device).type
    backend = "nccl" if dev_type == "cuda" else "gloo"
    if dev_type == "cuda":
        for var, value in NCCL_ENV.items():
            os.environ.setdefault(var, value)
    timeout = float(TIMEOUT_S)
    store = _dist().TCPStore("127.0.0.1", 0, world, is_master=True,
                             timeout=_timedelta(timeout),
                             wait_for_workers=False)
    g = _Group(world, timeout, backend == "nccl")
    payload = dict(cell=cell, cfg=cfg, spec=spec, seed=seed,
                   seconds=seconds, trace=bool(trace), world=world,
                   port=store.port, timeout=timeout, backend=backend,
                   device_type=dev_type, module=module,
                   traffic_dir=str(traffic.DIR), plants=_plant_refs(),
                   parent=os.getpid())
    _GROUP = g
    try:
        g.start(payload)
        dev0 = torch.device("cuda", 0) if dev_type == "cuda" else \
            torch.device("cpu")
        with _collective():
            _init(backend, store, 0, world, timeout + RANK0_EXTRA_S, dev0)
        yield dev0
        leave()
        g.done.set()
        g.finish()
    except BaseException as e:
        g.done.set()
        g.settle()
        g.kill()
        if g.hard:    # a process group over dead peers may never tear down
            traceback.print_exc()
            why = g.failure or g.message("rank 0 failed", None)
            sys.stderr.write(f"portbench: {why}\n")
            sys.stderr.flush()
            os._exit(3)
        if g.failure is not None and e is not g.failure:
            raise g.failure from e
        raise
    finally:
        g.close()
        _GROUP = None
        if _dist().is_initialized():     # gloo, after a failure
            _dist().destroy_process_group()
        del store


def _die_with_parent(parent: int) -> None:
    """End this process when ``parent`` ends: the kernel's parent-death
    signal where it has one, and a thread that watches the parent id."""
    with contextlib.suppress(OSError, AttributeError):
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0)
    if os.getppid() != parent:
        os._exit(1)

    def watch():
        while True:
            time.sleep(0.5)
            if os.getppid() != parent:
                os._exit(1)
    threading.Thread(target=watch, daemon=True).start()


def _load_plant(path: str, name: str):
    """Function ``name`` of the file ``path``: from the module already
    loaded from it (a runner's own faults patch that module), else from a
    fresh load."""
    for mod in list(sys.modules.values()):
        if getattr(mod, "__file__", None) == path:
            return getattr(mod, name)
    key = f"portbench_plant_{abs(hash(path))}"
    mod = sys.modules.get(key)
    if mod is None:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return getattr(mod, name)


def _follower() -> int:
    """A child's main: the group, the follower's part, the JAX check."""
    p = json.loads(sys.stdin.read())
    _die_with_parent(p["parent"])
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    import torch
    torch.set_num_threads(1)
    from portbench import traffic
    r = p["rank"]
    dev = torch.device("cuda", r) if p["device_type"] == "cuda" else \
        torch.device("cpu")
    store = _dist().TCPStore("127.0.0.1", p["port"], p["world"],
                             is_master=False,
                             timeout=_timedelta(p["timeout"]))
    _init(p["backend"], store, r, p["world"], p["timeout"], dev)
    traffic.DIR = Path(p["traffic_dir"])
    mod = importlib.import_module(p["module"]) if p["module"] else \
        traffic.runner(p["spec"]["kind"])
    try:
        for path, name in p["plants"]:
            _load_plant(path, name)(setattr)
        mod.follow(p["cell"], p["cfg"], p["spec"], p["seed"], p["seconds"],
                   p["trace"], dev)
        leave()
    except BaseException:
        # a process group left alive aborts the interpreter's exit: leave
        # at once, with the traceback as this rank's last lines
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: rank {r} loaded {', '.join(bad)}", flush=True)
        return 3
    return 0


# ----------------------------------------------------------- the card check

CHECK_STEPS = 1000
CHECK_GATHERS = 200
CHECK_N = 10_000_000
CHECK_QUERIES = 8192
CHECK_K = 10


def _digest(cfg: dict, seed: int, device) -> str:
    """sha256 of the bytes of ``data.make``'s base and queries."""
    import hashlib
    from portbench import data
    base, queries = data.make(cfg, CHECK_QUERIES, seed, device)
    h = hashlib.sha256()
    for t in (base, queries):
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def _check_part(cfg: dict, seed: int, device) -> dict:
    """What every rank does in the check, in the same order; rank 0's
    readings in the dict."""
    import torch
    from portbench.trace import sync
    out = {}
    lead = rank() == 0
    times = []
    for j in range(CHECK_STEPS):
        t = time.perf_counter()
        step(j) if lead else step()
        sync(device)
        times.append(time.perf_counter() - t)
    step(-1) if lead else step()
    out["step_us"] = 1e6 * sorted(times)[len(times) // 2]
    mine = torch.zeros((2, CHECK_QUERIES, CHECK_K), dtype=torch.float32,
                       device=device)
    got = [torch.empty_like(mine) for _ in range(world())]
    times = []
    for _ in range(CHECK_GATHERS):
        sync(device)
        t = time.perf_counter()
        with _collective():
            _dist().all_gather(got, mine)     # as the port's fan-out does
            sync(device)
        times.append(time.perf_counter() - t)
    out["all_gather_us"] = 1e6 * sorted(times)[len(times) // 2]
    out["digests"] = gather(_digest(cfg, seed, device))
    out["names"] = gather(torch.cuda.get_device_name(device)
                          if device.type == "cuda" else "cpu")
    return out


def follow(cell, cfg, spec, seed, seconds, trace, device):
    """The check's follower part."""
    gather(None)
    _check_part(cfg, seed, device)


def check(world_size: int, device: str, n: int, seed: int) -> dict:
    import torch
    from portbench import manifest
    man = manifest.load(ROOT)
    cfg = manifest.config(man, "deep1m-hnsw32-sq8", ROOT)
    cfg["n"] = n
    t0 = time.perf_counter()
    with launched("check", cfg, {}, seed, 0.0, False, device, world_size,
                  module="portbench.ranks") as dev:
        gather(None)
        up_s = time.perf_counter() - t0
        out = _check_part(cfg, seed, dev)
        print(f"check, before the group's teardown: up {up_s} s, {out}",
              file=sys.stderr, flush=True)
    nccl = None
    if torch.device(device).type == "cuda":
        nccl = ".".join(map(str, torch.cuda.nccl.version()))
    return {"ranks": world_size, "n": n, "seed": seed, "nccl": nccl,
            "group_up_s": up_s, "step_us": out["step_us"],
            "all_gather_us": out["all_gather_us"],
            "all_gather_shape": [2, CHECK_QUERIES, CHECK_K],
            "names": out["names"], "digests": out["digests"],
            "digests_equal": len(set(out["digests"])) == 1}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true", required=True)
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=CHECK_N)
    ap.add_argument("--seed", type=int, default=2_147_483_701)
    a = ap.parse_args(argv)
    import torch
    torch.set_num_threads(1)
    if a.device == "cuda" and (not torch.cuda.is_available() or
                               torch.cuda.device_count() < a.ranks):
        print(f"portbench: the check needs {a.ranks} CUDA devices",
              file=sys.stderr)
        return 2
    out = check(a.ranks, a.device, a.n, a.seed)
    print(json.dumps(out), flush=True)
    return 0 if out["digests_equal"] else 1


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    from portbench import ranks as _ranks
    sys.exit(_ranks.main())
