"""Real-time deployment loop on the GPU: the native executor around the
port's NMPC step at a fixed rate (the port's counterpart of the root
deploy_rt.py):

    python -m tum_control_tpu_torch.deploy_rt [--period 0.02] [--cycles 500]
        [--controller nominal|snmpc|rnmpc] [--telemetry PATH] [--pipeline N]
        [--lead-cap 1.5] [--device cuda|cpu]

Runs one scenario's control cycle (planner + RTI solve on `--device`, cuda
by default: without a card the run raises unless `--device cpu` is given;
the plant simulation stands in for the vehicle) under the C++ real-time
executor (utils/rt_runtime.py): absolute-deadline scheduling, deadline-miss
counting, lock-free telemetry, native p50/p99 latency against the period.

--pipeline N (default 0 = synchronous) runs the serving architecture of
three decoupled roles, so that the hard-deadline path never blocks on the
device:

  dispatcher  — deadline-aware pacing: the dispatcher and the applicator
                share one absolute deadline grid d_k; step k is dispatched
                at d_k - lead, where the lead tracks the 99th percentile of
                the measured completion latency plus 1 ms, clipped to
                [0.25 periods, --lead-cap periods]. Every launch of a step
                comes from this thread: the carry stays on the device and
                is chained on one stream, with no host sync in the step.
                After the step, its packed telemetry vector is copied into
                pinned host memory with `non_blocking=True` and a CUDA event
                is recorded behind the copy;
  fetchers    — a pool of 3 threads waits on each step's event (releasing
                the interpreter lock while it waits), publishes the newest
                completed result and feeds the completion-latency estimate
                that sets the lead;
  applicator  — the real-time thread: at every deadline it applies the
                freshest *completed* control and never blocks: its cycle
                body is pure memory reads and the executor's calls, no
                torch call. When no new result is in, it holds the previous
                control and counts a stale cycle.

On a card the served step is one CUDA graph (`packed_step`): its first
call for a graph key runs eagerly, the second captures the step and every
later call replays it, so a cycle's host work is a few identity checks and
one graph launch where the eager step is some 3,500 PyTorch calls of
Python dispatch. On the CPU the step stays eager. The dispatcher still
competes with the applicator, the fetchers and the sentinel for the
interpreter lock; `sys.setswitchinterval(0.0005)` hands the lock to the
applicator often, but late cycle starts remain possible. A sentinel
thread stamps the clock every 2 ms; every late cycle start is classified
against the sentinel's freeze windows (> 10 ms gaps) and reported, with
the attribution of the stale holds and the age decomposition (host
enqueue, completion, phase wait) of the applied controls.

Telemetry per cycle: synchronous mode records the solve time (dispatch to
the packed vector on the host); pipelined mode records the sensor-to-
actuator AGE of the applied control (now - dispatch time of its step).
"""
from __future__ import annotations

import argparse
import gc
import os
import queue
import sys
import threading
import time
import weakref

import numpy as np
import torch

from tum_control_tpu_torch.api import build_simulation
from tum_control_tpu_torch.config import MPCConfig, SimConfig
from tum_control_tpu_torch.device import resolve_device
from tum_control_tpu_torch.sim.disturbances import TYPE_NONE
from tum_control_tpu_torch.utils.rt_runtime import RealtimeExecutor
from tum_control_tpu_torch.utils.trace import span

N_FETCH = 3        # fetcher pool size
PACKED = 9         # [u0, u1, cost, time, sqp_iter, qp_iter, status, lat_dev, vel_dev]
WARMUP_STEPS = 2   # packed_step's eager call, then its graph's capture

# packed_step's calls by how each ran: eagerly (on the CPU, or the first
# call of a graph key), capturing the step's graph, or replaying it
GRAPH_STEPS = {"eager": 0, "capture": 0, "replay": 0}


def pack_telemetry(log):
    """The first scenario's telemetry as ONE float32 vector (one
    device->host copy per cycle): simU (2), simSolverDebug (5), lat_dev,
    vel_dev."""
    packed = torch.cat([log.simU[0], log.simSolverDebug[0], log.lat_dev, log.vel_dev])
    return packed.to(torch.float32)


def _eager_step(sim, carry, zeros):
    carry, log = sim.step(carry, zeros, zeros)
    return carry, pack_telemetry(log)


def _tensors(tree) -> list:
    """The tensors of a SimCarry (a tree of NamedTuples, tensors and other
    leaves), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [t for x in tree for t in _tensors(x)]
    return []


def _cloned(tree):
    """`tree` with a clone of each tensor; other leaves kept."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple):
        return type(tree)(*(_cloned(x) for x in tree))
    return tree


def draws(sim) -> bool:
    """Whether a step draws from the carry's generator (a disturbance or
    measurement-noise stream that is on and not played back)."""
    return not sim.playback and (sim.dist_deriv.kind != TYPE_NONE
                                 or sim.dist_se.kind != TYPE_NONE)


def graph_objects(sim, carry) -> tuple:
    """What a replay reads by reference and cannot see replaced: the
    controller, the lap, the plant's and the controller's tires and, where
    the step draws, the carry's generator."""
    ctrl = sim.controller
    tires = getattr(ctrl, "tp", getattr(getattr(ctrl, "base", None), "tp", None))
    return (ctrl, sim.traj, sim.tp_sim, tires, carry.key if draws(sim) else None)


def graph_signature(carry, zeros) -> tuple:
    """The shapes, dtypes and devices of the carry's tensors and of `zeros`."""
    return tuple((t.shape, t.dtype, t.device) for t in _tensors(carry) + [zeros])


class StepGraph:
    """One sim's served step as a CUDA graph: its key (graph_objects by
    identity, graph_signature by value), the static carry and zeros the
    graph reads, and the packed vector it writes. The graph ends by copying
    the step's new carry into the static carry, so the static carry is both
    the replay's input and its output."""

    def __init__(self, objects: tuple, signature: tuple):
        self.objects, self.signature = objects, signature
        self.graph = self.carry = self.zeros = self.packed = None

    def fits(self, sim, carry, zeros) -> bool:
        objects = graph_objects(sim, carry)
        if any(a is not b for a, b in zip(objects, self.objects)):
            return False
        if carry is self.carry and zeros is self.zeros:
            return True
        return graph_signature(carry, zeros) == self.signature

    def load(self, carry, zeros):
        """Copy into the static buffers each tensor of `carry` and `zeros`
        that is not already the static one (nothing when `carry` is the
        carry the last replay returned)."""
        if carry is not self.carry:
            for s, t in zip(_tensors(self.carry), _tensors(carry)):
                if s is not t:
                    s.copy_(t)
        if zeros is not self.zeros:
            self.zeros.copy_(zeros)

    def capture(self, sim, carry, zeros):
        """Static buffers from `carry` and `zeros`, one eager step on a side
        stream (the warm-up the CUDA graph documentation prescribes; its
        draws are taken back), then the step captured on the carry's card."""
        self.carry, self.zeros = _cloned(carry), zeros.clone()
        gen = carry.key if draws(sim) else None
        state = gen.get_state() if gen is not None else None
        stream = torch.cuda.current_stream(carry.x_sim.device)
        side = torch.cuda.Stream(carry.x_sim.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            _eager_step(sim, self.carry, self.zeros)
        stream.wait_stream(side)
        if gen is not None:
            gen.set_state(state)
        graph = torch.cuda.CUDAGraph()
        if gen is not None:
            graph.register_generator_state(gen)
        # thread_local: another thread's CUDA calls (the pipelined loop's
        # fetchers) do not void a capture made in the dispatcher
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            new, self.packed = _eager_step(sim, self.carry, self.zeros)
            # the step's outputs are new tensors (none is an input), so
            # each copy reads what the step wrote
            for s, o in zip(_tensors(self.carry), _tensors(new)):
                s.copy_(o)
        self.graph = graph


_GRAPHS = weakref.WeakKeyDictionary()  # sim -> its StepGraph


def packed_step(sim, carry, zeros):
    """One closed-loop step of the single scenario and its telemetry packed
    into one float32 device vector (pack_telemetry): (new carry, packed).

    On the CPU the step runs eagerly. On a card it is a CUDA graph, one per
    sim: the first call for a graph key (StepGraph: the controller, lap and
    tires by identity, the draw generator where the step draws, the
    carry's shapes, dtypes and device) runs eagerly, so the hand kernels
    build; the second captures the step and replays it; every later call
    with the same key replays it. A carry or `zeros` that is not the one
    the last replay returned is copied into the graph's buffers first.
    Tensors changed in place are seen by the replay. On a card the returned
    carry and `packed` are the graph's own buffers: they hold until the
    next packed_step on the same sim, which overwrites them (clone what
    must outlive it). A replay is the span `tc.step`; the spans inside the
    step and the kernels' LAUNCHES count only eager and captured steps."""
    if carry.x_sim.device.type != "cuda":
        GRAPH_STEPS["eager"] += 1
        return _eager_step(sim, carry, zeros)
    g = _GRAPHS.get(sim)
    if g is None or not g.fits(sim, carry, zeros):
        _GRAPHS[sim] = StepGraph(graph_objects(sim, carry), graph_signature(carry, zeros))
        GRAPH_STEPS["eager"] += 1
        return _eager_step(sim, carry, zeros)
    if g.graph is None:
        g.capture(sim, carry, zeros)
        GRAPH_STEPS["capture"] += 1
    else:
        g.load(carry, zeros)
        GRAPH_STEPS["replay"] += 1
    with span("tc.step"):
        g.graph.replay()
    return g.carry, g.packed


def dispatch_step(sim, carry, zeros, row):
    """The pipelined dispatcher's part of a cycle: packed_step, its vector
    copied into the pinned host `row` with non_blocking=True, and on CUDA an
    event recorded behind the copy on the carry's card (None on the CPU).
    Nothing here waits for the device. Returns (carry, event)."""
    carry, packed = packed_step(sim, carry, zeros)
    row.copy_(packed, non_blocking=True)
    device = carry.x_sim.device
    if device.type != "cuda":
        return carry, None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return carry, ev


def _record(ex, t0, ns, p):
    ex.record(t0, ns, int(p[6]), float(p[2]), float(p[7]), float(p[8]),
              float(p[0]), float(p[1]))


def run_synchronous(sim, carry, ex, cycles: int):
    """Each cycle: wait for the deadline, step, copy the packed vector to the
    host, record. A cycle is the span `tc.cycle` (its index the cycle's),
    the wait for the packed vector the span `tc.cycle.fetch` inside it."""
    zeros = torch.zeros_like(carry.x_sim)
    for i in range(cycles):
        with span("tc.cycle", index=i):
            t0 = ex.begin_cycle()
            t_solve = time.perf_counter_ns()
            carry, packed = packed_step(sim, carry, zeros)
            with span("tc.cycle.fetch"):
                p = packed.cpu().numpy()  # waits for the step
            _record(ex, t0, time.perf_counter_ns() - t_solve, p)


def _read_steal_s():
    """Hypervisor steal time from /proc/stat (an out-of-process cross-check
    on the sentinel's classification), or None where it cannot be read."""
    try:
        with open("/proc/stat") as f:
            return int(f.readline().split()[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return None


def run_pipelined(sim, carry, ex, cycles: int, period: float, depth: int, lead_cap: float):
    """The three-role serving loop (module doc). Returns a dict of its
    counts: stale cycles, distinct controls, the age decomposition, the
    freeze windows and the classification of late starts and stale holds,
    and `apply_log`, the step applied at each cycle (numpy int64)."""
    period_ns = int(period * 1e9)
    device = carry.x_sim.device
    zeros = torch.zeros_like(carry.x_sim)
    # one pinned host row per step: the copy of step i lands in host[i]
    host = torch.empty((cycles, PACKED), dtype=torch.float32,
                       pin_memory=device.type == "cuda")
    host_np = host.numpy()
    steal_before = _read_steal_s()

    fetch_q = queue.Queue()
    # in-flight bound: a safety valve that covers the largest lead
    inflight = threading.Semaphore(max(depth, 4))
    latest = [None]  # single-slot publish: (seq, t_disp_ns, t_done_ns, row)
    done = threading.Event()
    worker_err = []
    lead_cap_ns = int(lead_cap * period_ns)
    lead = [min(int(1.5 * period_ns), lead_cap_ns)]
    comp_ring = []  # last <= 256 completion latencies (fetcher-owned)
    comp_lock = threading.Lock()
    comp_log = np.zeros(cycles, dtype=np.int64)   # completion latency per seq
    disp_log = np.zeros(cycles, dtype=np.int64)   # dispatch time per seq
    disp_tgt = np.zeros(cycles, dtype=np.int64)   # scheduled dispatch per seq
    lead_log = np.zeros(cycles, dtype=np.int64)   # lead used per seq
    done_log = np.zeros(cycles, dtype=np.int64)   # publish time per seq
    enq_log = np.zeros(cycles, dtype=np.int64)    # host time to enqueue step seq

    # shared absolute deadline grid, 250 ms ahead so that every thread is
    # up before d_0; the applicator publishes its real grid (the executor
    # re-anchors after a miss) and the dispatcher follows it
    t_base = time.perf_counter_ns() + 250_000_000
    deadlines = t_base + period_ns * np.arange(cycles, dtype=np.int64)
    apply_clock = [None]  # (cycle index, cycle start ns), applicator-owned

    freezes = []
    stop_sentinel = threading.Event()

    def sentinel():
        prev = time.perf_counter_ns()
        while not stop_sentinel.is_set():
            time.sleep(0.002)
            now = time.perf_counter_ns()
            if now - prev > 10_000_000:
                freezes.append((prev, now))
            prev = now

    def dispatcher():
        nonlocal carry
        try:
            for i in range(cycles):
                lead_log[i] = lead[0]
                ac = apply_clock[0]
                base = int(deadlines[i]) if ac is None else ac[1] + (i - ac[0]) * period_ns
                t_target = base - lead[0]
                disp_tgt[i] = t_target
                now = time.perf_counter_ns()
                if now < t_target:
                    time.sleep((t_target - now) / 1e9)
                inflight.acquire()
                t_disp = time.perf_counter_ns()
                disp_log[i] = t_disp
                carry, ev = dispatch_step(sim, carry, zeros, host[i])
                enq_log[i] = time.perf_counter_ns() - t_disp
                fetch_q.put((i, t_disp, ev))
            fetch_q.put(None)
        except BaseException as e:  # publish, then end the run
            worker_err.append(e)
            fetch_q.put(None)
            done.set()

    fetch_done = [threading.Event() for _ in range(N_FETCH)]

    def fetcher(fid):
        try:
            while True:
                item = fetch_q.get()
                if item is None:
                    fetch_q.put(None)  # propagate to the pool's peers
                    break
                seq, t_disp, ev = item
                if ev is not None:
                    ev.synchronize()  # releases the interpreter lock while it waits
                t_done = time.perf_counter_ns()
                comp = t_done - t_disp
                comp_log[seq] = comp
                done_log[seq] = t_done
                with comp_lock:
                    comp_ring.append(comp)
                    if len(comp_ring) > 256:
                        del comp_ring[0]
                    q99 = float(np.percentile(comp_ring, 99))
                    lead[0] = int(min(max(q99 + 1_000_000, 0.25 * period_ns), lead_cap_ns))
                    cur = latest[0]
                    if cur is None or seq > cur[0]:  # newest-seq-wins
                        latest[0] = (seq, t_disp, t_done, host_np[seq])
                inflight.release()
            fetch_done[fid].set()
            if all(e.is_set() for e in fetch_done):
                done.set()
        except BaseException as e:
            worker_err.append(e)
            done.set()

    stale_cycles = 0
    applied_seqs = set()
    t0s = np.zeros(cycles, dtype=np.int64)
    apply_log = np.zeros(cycles, dtype=np.int64)  # applied seq per cycle
    ts = threading.Thread(target=sentinel, daemon=True)
    td = threading.Thread(target=dispatcher, daemon=True)
    tfs = [threading.Thread(target=fetcher, args=(i,), daemon=True) for i in range(N_FETCH)]
    old_switch = sys.getswitchinterval()
    gc.collect()
    gc.freeze()
    gc.disable()  # no collector pauses on the hot path; re-enabled in finally
    sys.setswitchinterval(0.0005)  # tight lock hand-off to the real-time thread
    try:
        ts.start()
        td.start()
        for tf in tfs:
            tf.start()
        while latest[0] is None:  # wait for the first completed control
            if worker_err:
                raise RuntimeError("serving worker failed") from worker_err[0]
            time.sleep(0.001)
        last_seq = -1
        rem = t_base - time.perf_counter_ns()
        if rem > 0:  # align the executor's grid with `deadlines`
            time.sleep(rem / 1e9)
        for i in range(cycles):
            t0 = ex.begin_cycle()
            apply_clock[0] = (i, t0)
            # hard real-time path: memory reads only, never the device
            seq, t_disp, _, p = latest[0]
            age_ns = time.perf_counter_ns() - t_disp
            if seq == last_seq:
                stale_cycles += 1
            last_seq = seq
            applied_seqs.add(seq)
            t0s[i] = t0
            apply_log[i] = seq
            _record(ex, t0, age_ns, p)
        td.join()
        done.wait()
        for tf in tfs:
            tf.join()
    finally:
        stop_sentinel.set()
        ts.join()
        gc.enable()
        gc.unfreeze()
        sys.setswitchinterval(old_switch)
    if worker_err:
        raise RuntimeError("serving worker failed") from worker_err[0]
    print(f"stale cycles (held previous control): {stale_cycles}/{cycles}; "
          f"distinct controls applied: {len(applied_seqs)}")

    # age of the applied controls = completion (dispatch -> on the host)
    # + phase wait (on the host -> actuation deadline); the completion's
    # first part is the host's enqueue of the step
    comp_applied = comp_log[apply_log] / 1e6
    phase = (t0s - done_log[apply_log]) / 1e6
    enq = enq_log[apply_log] / 1e6
    pct = lambda a, q: float(np.percentile(a, q))
    age = {"completion_p50": pct(comp_applied, 50), "completion_p99": pct(comp_applied, 99),
           "enqueue_p50": pct(enq, 50), "enqueue_p99": pct(enq, 99),
           "phase_wait_p50": pct(phase, 50), "phase_wait_p99": pct(phase, 99),
           "final_lead_ms": lead[0] / 1e6}
    print(f"age decomposition [ms]: completion(solve+copy) p50/p99 "
          f"{age['completion_p50']:.1f}/{age['completion_p99']:.1f} (host enqueue "
          f"{age['enqueue_p50']:.1f}/{age['enqueue_p99']:.1f}); "
          f"phase-wait p50/p99 {age['phase_wait_p50']:.1f}/{age['phase_wait_p99']:.1f}; "
          f"final adaptive lead {age['final_lead_ms']:.1f}")

    in_freeze = lambda t: any(a - period_ns <= t <= b + 2 * period_ns for a, b in freezes)
    # late cycle start: an inter-start gap above the period (the executor
    # re-anchors after a miss); 50 us of stamp skew allowed
    late_idx = np.nonzero(np.diff(t0s) > period_ns + 50_000)[0] + 1
    env_induced = sum(1 for li in late_idx if in_freeze(int(t0s[li])))
    steal_after = _read_steal_s()
    steal = (steal_after - steal_before
             if steal_before is not None and steal_after is not None else None)
    print(f"host freezes (sentinel gaps >10 ms): {len(freezes)}, "
          f"total {sum(b - a for a, b in freezes) / 1e6:.1f} ms frozen; "
          f"late cycle starts: {len(late_idx)} "
          f"({env_induced} environment-induced / {len(late_idx) - env_induced} "
          f"application-induced)"
          + (f"; /proc/stat steal during run: {steal:.2f} s" if steal is not None else ""))

    # stale-hold attribution: the pending step came in beyond the q99
    # envelope it was dispatched with, or a freeze window covers the cycle
    # or the step's late dispatch
    stale_mask = np.zeros(cycles, dtype=bool)
    stale_mask[1:] = apply_log[1:] == apply_log[:-1]
    n_env_stale = 0
    for ci in np.nonzero(stale_mask)[0]:
        pend = min(int(apply_log[ci]) + 1, cycles - 1)
        tail = comp_log[pend] > lead_log[pend] - 1_500_000
        disp_frozen = (disp_log[pend] - disp_tgt[pend] > 2_000_000
                       and in_freeze(int(disp_log[pend])))
        if tail or in_freeze(int(t0s[ci])) or disp_frozen:
            n_env_stale += 1
    print(f"stale holds attributable to completion-tail/freeze excursions: "
          f"{n_env_stale}/{int(stale_mask.sum())} (q99 lead envelope, final "
          f"{lead[0] / 1e6:.1f} ms)")
    return {"stale_cycles": stale_cycles, "distinct_controls": len(applied_seqs), "age": age,
            "freezes": len(freezes), "frozen_ms": sum(b - a for a, b in freezes) / 1e6,
            "late_starts": int(len(late_idx)), "late_env": int(env_induced),
            "late_app": int(len(late_idx) - env_induced),
            "stale_attributed": n_env_stale, "steal_s": steal, "apply_log": apply_log}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--period", type=float, default=0.02)
    ap.add_argument("--cycles", type=int, default=500)
    ap.add_argument("--controller", default="nominal", choices=["nominal", "snmpc", "rnmpc"])
    ap.add_argument("--telemetry", default=None)
    ap.add_argument("--pipeline", type=int, default=0,
                    help="steps kept in flight (0 = synchronous)")
    ap.add_argument("--lead-cap", type=float, default=1.5,
                    help="max dispatch lead in periods (age-p50 design target)")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    return ap.parse_args(argv)


def main(argv=None, dtype=torch.float32):
    """Serve `--cycles` cycles; returns a dict: `mode`, the executor's
    `stats`, `exported` (records written to --telemetry) and, pipelined, the
    counts of `run_pipelined`."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    sim_cfg = SimConfig(sim_mode=0, T=args.cycles * 0.02)
    sim, x0m, x0s, _, _ = build_simulation(sim_cfg, MPCConfig(controller=args.controller),
                                           device=device, dtype=dtype)
    carry = sim.init_carry(x0m[None], x0s[None], key=0)

    # warm-up outside the timed loop, before any serving thread starts: the
    # kernels build at the first (eager) call, the caching allocator takes
    # its blocks, and on a card the second call captures the step's graph
    zeros = torch.zeros_like(carry.x_sim)
    for _ in range(WARMUP_STEPS):
        _, packed0 = packed_step(sim, carry, zeros)
    packed0.cpu()

    ex = RealtimeExecutor(period_s=args.period)
    mode = f"pipeline={args.pipeline}" if args.pipeline else "synchronous"
    print(f"running {args.cycles} cycles at {args.period * 1e3:.0f} ms period ({mode}) "
          f"on {device} ...")
    result = {"mode": mode}
    try:
        if args.pipeline:
            result.update(run_pipelined(sim, carry, ex, args.cycles, args.period,
                                        args.pipeline, args.lead_cap))
        else:
            run_synchronous(sim, carry, ex, args.cycles)
        stats = ex.stats()
        print(stats)
        # pipelined: the age of each applied control against the (N+1)-period
        # envelope; synchronous: the blocking solve against the period
        budget_ms = args.period * 1e3 * (args.pipeline + 1 if args.pipeline else 1)
        print(f"p99 {'age' if args.pipeline else 'solve'} {stats['solve_ms_p99']:.3f} ms "
              f"vs {budget_ms:.0f} ms {'sensor-to-actuator ' if args.pipeline else ''}budget; "
              f"misses {stats['deadline_misses']}/{stats['cycles']}")
        result["stats"] = stats
        if args.telemetry:
            result["exported"] = ex.export(args.telemetry)
            print(f"exported {result['exported']} telemetry records to {args.telemetry}")
    finally:
        ex.close()
    return result


if __name__ == "__main__":
    main()
