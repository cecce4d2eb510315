"""Human run report from the observability artifacts (counterpart of
``scripts/gs_report.py``, of which it is a copy over this package's
``obs``).

Renders the observability outputs — the ``GS_TPU_STATS`` summary JSON,
the ``GS_TRACE`` Chrome trace, the ``GS_EVENTS`` stream and the
``GS_METRICS`` interval files — into one operator-facing story: where
the wall time went, the slowest step rounds, how much I/O and comm was
exposed vs hidden, the step-latency percentiles, the build and launch
analytics, and the fault / restart timeline with per-attempt wall-time
attribution.

    python -m grayscott_jl_tpu_torch.obs.report --stats stats.json \
        --trace trace.json --events events.jsonl [--top 5]

    # validation mode: schema-check the artifacts, render nothing
    python -m grayscott_jl_tpu_torch.obs.report --check \
        --trace trace.json --events events.jsonl

The same sections, event schema, ``--check`` mode and exit codes as the
reference's script: 0 on success, 1 when ``--check`` finds a problem or
a requested artifact is unreadable. The tenants and fleet sections
render the serving layer's events (``serve/``: ``job_*``, ``worker_*``,
``job_failover``, ``cache_*``), merged over a fleet's ``.rank<N>``
files. Stdlib only, with this package's
``obs`` helpers.
"""

from __future__ import annotations

import argparse
import json
import sys

from .events import parse_events_multi, rank_files
from .trace import validate_trace


def _fmt_s(v) -> str:
    return f"{v:.3f}s" if isinstance(v, (int, float)) else "-"


#: The full GS_EVENTS kind registry of the reference: every kind a
#: producer can emit, mapped to the attrs it must carry. Journal-mirrored
#: kinds (``FaultJournal.record``) carry their failure-taxonomy ``kind``
#: as the ``fault`` attr.
EVENT_KIND_SCHEMA = {
    # driver lifecycle
    "run_start": ("model", "L", "steps", "kernel", "mesh"),
    "output": ("output_step",),
    "checkpoint": (),
    "run_complete": ("wall_s", "steps", "attempt"),
    "run_error": ("error", "attempt"),
    "shutdown_requested": ("signum",),
    # tuning / observability producers
    "autotune": ("mode", "source", "kernel"),
    "numerics": ("fields",),
    "drift": ("tripped", "limit", "policy"),
    "executable": ("name", "compile_s"),
    # resilience (journal-mirrored)
    "injected": ("fault", "planned_step"),
    "health": ("fault", "policy", "action"),
    "recovery": ("fault", "attempt", "action"),
    "gave_up": ("fault", "attempt", "error"),
    "attempt_phases": ("attempt", "phases_s", "steps"),
    "rendezvous": ("round", "attempt", "procs"),
    "mesh_agreement": ("round", "devices", "procs"),
    "graceful_shutdown": ("signal",),
    "hang": ("fault", "deadline_s", "threads"),
    "hang_exit": ("fault", "exit_code"),
    # elastic resharding: every move — host checkpoint restore or
    # live device reshape — records its path tier (ckpt / collective /
    # put / host), true-domain bytes moved, and wall time, so reshard
    # cost is first-class provenance (docs/RESHARD.md).
    "reshard": ("members", "path", "bytes", "wall_s"),
    # the serve elastic policy's grow/shrink decisions
    # (serve/elastic.py, docs/SERVICE.md "Elastic capacity")
    "elastic": ("action", "batch", "depth", "utilization"),
    # data integrity (resilience/integrity.py, docs/RESILIENCE.md):
    # detected silent corruption (CRC / device-checksum mismatch,
    # damaged writer metadata), a restore failing over to a healthy
    # checkpoint replica, and the boundary scrubber's audit summary.
    # The injected chaos kinds (`bitflip`, `ckpt_corrupt`) ride the
    # `injected` record like every other fault, in its `fault` attr.
    "corruption": ("detail",),
    "replica_failover": ("path", "detail"),
    "scrub": ("path", "steps_audited", "corrupt"),
    # simulation-as-a-service job lifecycle (serve/, docs/SERVICE.md);
    # every record carries the tenant so the per-tenant timeline below
    # can attribute multi-tenant traffic from one stream.
    "job_submitted": ("job", "tenant", "priority", "model", "L",
                      "steps"),
    "job_packed": ("job", "tenant", "batch", "slot", "members"),
    "job_requeued": ("job", "tenant", "batch", "fault"),
    "job_complete": ("job", "tenant", "status"),
    "job_rejected": ("job", "tenant", "reason"),
    # distributed serve fleet + result cache (serve/cluster.py,
    # serve/cache.py; docs/SERVICE.md "the distributed fleet"):
    # membership joins/losses, a dead worker's batch failing over to
    # the fleet, and the content-addressed cache's hit/miss/publish
    # provenance (the digest names the physics; byte-identical replay
    # is the contract).
    # compute-path SDC screening (resilience/sdc.py,
    # docs/RESILIENCE.md "Silent data corruption"): every redundant-
    # compute check (ok or not), a mismatch's device/member
    # attribution, the quarantine verdict, and a serve member marking
    # its own inventory suspect. The injected chaos kind (`sdc`) rides
    # the `injected` record like every other fault.
    "sdc_check": ("mode", "replayed_steps", "status"),
    "sdc_mismatch": ("mode", "device", "replayed_steps",
                     "verified_step"),
    "device_quarantined": ("device", "reason"),
    "worker_degraded": ("reason",),
    "worker_join": ("worker", "role"),
    "worker_lost": ("worker",),
    "job_failover": ("job", "tenant", "batch", "worker"),
    "cache_hit": ("digest", "job", "tenant"),
    "cache_miss": ("digest", "job", "tenant"),
    "cache_publish": ("digest", "job", "store"),
}


def _check_event(path, i, e, problems) -> None:
    missing = [k for k in ("ts", "kind") if k not in e]
    if missing:
        problems.append(
            f"events {path}: record {i} missing {missing}"
        )
        return
    if e["kind"] not in EVENT_KIND_SCHEMA:
        problems.append(
            f"events {path}: record {i} has unknown kind "
            f"{e['kind']!r} (not in EVENT_KIND_SCHEMA)"
        )
        return
    required = EVENT_KIND_SCHEMA[e["kind"]]
    if required:
        attrs = e.get("attrs") or {}
        missing = [k for k in required if k not in attrs]
        if missing:
            problems.append(
                f"events {path}: {e['kind']} record {i} missing "
                f"attrs {missing}"
            )
        if e.get("kind") == "numerics" and "fields" not in missing:
            for fname, stats in (attrs["fields"] or {}).items():
                bad = [s for s in ("min", "max", "mean", "l2",
                                   "nonfinite")
                       if not isinstance(stats.get(s), (int, float))]
                if bad:
                    problems.append(
                        f"events {path}: numerics record {i} field "
                        f"{fname!r} missing stats {bad}"
                    )


def _check_halo_depth_gate(stats_path, gate, problems) -> None:
    """Validate a ``halo_depth_gate`` provenance record
    (docs/TEMPORAL.md): a degraded s-step request must say what was
    asked, what ran, and WHY.  Two generations exist: the legacy
    blanket-degrade record (requested/applied/reason only) and the
    geometry-infeasible record (``kind`` + the VMEM ledger numbers in
    ``geometry``) — a ``kind`` outside that registry, or a ledger
    record missing its numbers, is a producer bug."""
    if gate is None:
        return
    if not isinstance(gate, dict):
        problems.append(
            f"stats {stats_path}: halo_depth_gate must be a dict, "
            f"got {type(gate).__name__}"
        )
        return
    for k in ("requested", "applied"):
        if not isinstance(gate.get(k), int):
            problems.append(
                f"stats {stats_path}: halo_depth_gate missing "
                f"integer {k!r}"
            )
    reason = gate.get("reason")
    if not (isinstance(reason, str) and reason.strip()):
        problems.append(
            f"stats {stats_path}: halo_depth_gate must carry a "
            f"nonempty reason string"
        )
    if "kind" not in gate:
        return  # legacy blanket-degrade record (pre-v8): accepted
    if gate["kind"] != "geometry-infeasible":
        problems.append(
            f"stats {stats_path}: halo_depth_gate kind must be "
            f"'geometry-infeasible', got {gate['kind']!r}"
        )
        return
    geo = gate.get("geometry")
    if not isinstance(geo, dict):
        problems.append(
            f"stats {stats_path}: geometry-infeasible "
            f"halo_depth_gate must carry a geometry ledger dict"
        )
        return
    for k in ("fuse_base", "requested_depth", "feasible_depth",
              "vmem_budget_bytes", "itemsize", "n_fields"):
        if not isinstance(geo.get(k), int):
            problems.append(
                f"stats {stats_path}: halo_depth_gate geometry "
                f"missing integer {k!r}"
            )
    shape = geo.get("local_shape")
    if not (isinstance(shape, list) and len(shape) == 3
            and all(isinstance(v, int) for v in shape)):
        problems.append(
            f"stats {stats_path}: halo_depth_gate geometry "
            f"local_shape must be a 3-int list, got {shape!r}"
        )


def check(trace_path, events_path, stats_path,
          metrics_path=None) -> int:
    """Schema validation (the chaos_smoke / CI entry): returns the
    process exit code. Multi-process runs are validated across every
    ``.rank<N>`` sibling of the named events/metrics path."""
    problems = []
    if trace_path:
        try:
            with open(trace_path, encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            problems.append(f"trace {trace_path}: unreadable ({e})")
        else:
            for p in validate_trace(doc):
                problems.append(f"trace {trace_path}: {p}")
            n = sum(1 for e in doc.get("traceEvents", [])
                    if isinstance(e, dict) and e.get("ph") == "X")
            if n == 0:
                problems.append(f"trace {trace_path}: no spans")
    if events_path:
        try:
            events = parse_events_multi(events_path)
        except OSError as e:
            problems.append(f"events {events_path}: unreadable ({e})")
        else:
            if not events:
                problems.append(f"events {events_path}: no events")
            for i, e in enumerate(events):
                _check_event(events_path, i, e, problems)
    if metrics_path:
        files = rank_files(metrics_path)
        if not files:
            problems.append(f"metrics {metrics_path}: no such file")
        for p in files:
            try:
                records = _read_metrics(p)
            except (OSError, json.JSONDecodeError) as e:
                problems.append(f"metrics {p}: unreadable ({e})")
                continue
            if not records:
                problems.append(f"metrics {p}: no records")
            for i, rec in enumerate(records):
                missing = [k for k in ("ts", "proc", "counters",
                                       "gauges", "histograms")
                           if k not in rec]
                if missing:
                    problems.append(
                        f"metrics {p}: record {i} missing {missing}"
                    )
    if stats_path:
        try:
            with open(stats_path, encoding="utf-8") as f:
                stats = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            problems.append(f"stats {stats_path}: unreadable ({e})")
        else:
            cfg = (stats.get("config")
                   if isinstance(stats, dict) else None)
            if isinstance(cfg, dict):
                sel = cfg.get("kernel_selection")
                if (cfg.get("kernel_language") in ("pallas", "cuda")
                        and isinstance(sel, dict)):
                    # Generated-kernel provenance: a resolved kernel
                    # pick (Pallas there, CUDA here) is a generator
                    # product,
                    # and the artifact must say which generator
                    # contract built it — hand-written-era records
                    # carry neither attr and predate this check.
                    if sel.get("generated") is not True:
                        problems.append(
                            f"stats {stats_path}: kernel_selection of "
                            f"a kernel run must record generated=true"
                        )
                    if not isinstance(sel.get("generator_version"),
                                      int):
                        problems.append(
                            f"stats {stats_path}: kernel_selection of "
                            f"a kernel run must record an integer "
                            f"generator_version"
                        )
                if isinstance(sel, dict):
                    at = sel.get("autotune")
                    if isinstance(at, dict) and "cache_schema" in at:
                        # v8 tuning provenance (docs/TUNING.md): the
                        # schema the decision was keyed under rides in
                        # the artifact; pre-v8 records carry no field
                        # and predate this check.
                        if not isinstance(at["cache_schema"], int):
                            problems.append(
                                f"stats {stats_path}: autotune "
                                f"provenance cache_schema must be an "
                                f"integer, got "
                                f"{at['cache_schema']!r}"
                            )
                    _check_halo_depth_gate(
                        stats_path, sel.get("halo_depth_gate"),
                        problems,
                    )
            rs = (cfg.get("reshard")
                  if isinstance(cfg, dict) else None)
            if isinstance(rs, dict) and rs.get("changed"):
                # Reshard provenance (docs/RESHARD.md): a run that
                # moved must say HOW — which path tier carried it,
                # how many bytes, how long.
                if rs.get("path") not in ("ckpt", "collective",
                                          "put", "host"):
                    problems.append(
                        f"stats {stats_path}: reshard record must "
                        f"carry a path tier (ckpt/collective/put/"
                        f"host), got {rs.get('path')!r}"
                    )
                for k in ("bytes", "wall_s"):
                    if not isinstance(rs.get(k), (int, float)):
                        problems.append(
                            f"stats {stats_path}: reshard record "
                            f"missing numeric {k!r}"
                        )
            comm = stats.get("comm") if isinstance(stats, dict) else None
            if isinstance(comm, dict):
                # The s-step visibility fields (docs/TEMPORAL.md) are
                # part of the comm schema: a stats writer that drops
                # them silently hides the exchange cadence the
                # halo_depth knob exists to change.
                missing = [k for k in ("halo_depth",
                                       "exchanges_per_step",
                                       "halo_bytes_per_step")
                           if k not in comm]
                if missing:
                    problems.append(
                        f"stats {stats_path}: comm section missing "
                        f"{missing}"
                    )
    for p in problems:
        print(f"gs-report: FAIL — {p}", file=sys.stderr)
    if not problems:
        print("gs-report: OK — artifacts validate")
    return 1 if problems else 0


def _read_metrics(path: str) -> list:
    """Interval snapshot records of one metrics JSONL file (torn tail
    lines skipped, like the event stream)."""
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict):
                out.append(rec)
    return out


def report_stats(stats: dict) -> None:
    cfg = stats.get("config", {})
    print("== run ==")
    print(f"  model={cfg.get('model')} L={stats.get('L')} "
          f"mesh={cfg.get('mesh_dims')} kernel="
          f"{cfg.get('kernel_language')} devices="
          f"{cfg.get('n_devices')} attempt={cfg.get('attempt', 0)}")
    print(f"  steps={stats.get('steps')} wall={_fmt_s(stats.get('wall_s'))} "
          f"cell-updates/s={stats.get('cell_updates_per_s')}")
    phases = stats.get("phases_s") or {}
    total = sum(phases.values()) or 1.0
    print("== phases ==")
    for name, v in sorted(phases.items(), key=lambda kv: -kv[1]):
        print(f"  {name:<16} {v:10.3f}s  {100 * v / total:5.1f}%")
    io = stats.get("io")
    if io:
        hidden = sum((io.get("hidden_s") or {}).values())
        exposed = sum((io.get("exposed_s") or {}).values())
        busy = hidden + exposed
        frac = exposed / busy if busy > 0 else 0.0
        print("== i/o overlap ==")
        print(f"  busy={busy:.3f}s hidden={hidden:.3f}s "
              f"exposed={exposed:.3f}s ({100 * frac:.1f}% exposed), "
              f"queue hwm={io.get('queue_depth_hwm')}")
    comm = stats.get("comm")
    if comm and comm.get("comm_us_per_step"):
        print("== comm (model projection) ==")
        print(f"  {comm.get('comm_us_per_step')}us/step, hidden="
              f"{comm.get('hidden_us')}us exposed="
              f"{comm.get('exposed_us')}us "
              f"(overlap={comm.get('overlap')})")
        ex = comm.get("exchanges_per_step")
        if ex is not None:
            per = round(1.0 / ex, 2) if ex else float("inf")
            print(f"  halo_depth={comm.get('halo_depth')}: one exchange "
                  f"per {per} steps, "
                  f"{comm.get('halo_bytes_per_step')} halo B/step")
    report_reshard(cfg.get("reshard"))
    metrics = stats.get("metrics")
    if metrics:
        for h in metrics.get("histograms", []):
            if h.get("name") == "step_latency_us":
                print("== step latency (per fused round) ==")
                print(f"  p50={h.get('p50')}us p95={h.get('p95')}us "
                      f"p99={h.get('p99')}us mean={h.get('mean')}us "
                      f"over {h.get('count')} rounds")
    report_numerics(stats.get("numerics"))
    report_executables(stats.get("executables"))


def report_reshard(rs) -> None:
    """The reshard provenance section: which path tier moved the run
    (host checkpoint restore vs the live device tiers), between which
    layouts, how many bytes, how fast (docs/RESHARD.md)."""
    if not isinstance(rs, dict) or not rs.get("changed"):
        return
    old = rs.get("old") or {}
    new = rs.get("new") or {}
    print(f"== reshard (path={rs.get('path')}) ==")
    print(f"  mesh {old.get('mesh_dims')} -> {new.get('mesh_dims')}, "
          f"procs {old.get('process_count')} -> "
          f"{new.get('process_count')}, "
          f"{rs.get('n_shards')} target shard(s)")
    by = rs.get("bytes")
    wall = rs.get("wall_s")
    if isinstance(by, (int, float)) and isinstance(wall, (int, float)):
        rate = by / wall / 1e6 if wall else float("inf")
        print(f"  moved {by} B in {_fmt_s(wall)} ({rate:.1f} MB/s)")
    members = rs.get("members")
    if members:
        print(f"  members: restored={members.get('restored')} "
              f"grown={members.get('grown')} "
              f"-> n={members.get('new_n')}")


def report_numerics(num) -> None:
    """The in-graph numerics section: last per-field statistics plus
    each statistic's worst windowed drift (docs/OBSERVABILITY.md)."""
    if not num:
        return
    print(f"== numerics (mode={num.get('mode')}, "
          f"{num.get('probes')} probes, window={num.get('window')}, "
          f"drift trips={num.get('drift_trips')}) ==")
    last = (num.get("last") or {}).get("fields") or {}
    drift = num.get("max_drift") or {}
    for field, s in last.items():
        print(f"  {field:<6} min={s.get('min'):.6g} "
              f"max={s.get('max'):.6g} mean={s.get('mean'):.6g} "
              f"l2={s.get('l2'):.6g} nonfinite={s.get('nonfinite')}")
        worst = {k.split(".", 1)[1]: v for k, v in drift.items()
                 if k.startswith(field + ".")}
        if worst:
            print("         max drift: " + " ".join(
                f"{k}={v:+.3f}" for k, v in worst.items()
            ))


def report_executables(ex) -> None:
    """The build and launch analytics table (``obs/xstats.py``): each
    library's build seconds and cache outcome, each kernel entry's
    registers, shared bytes, occupancy and cost per launch, the exchange
    census, and the model-vs-measured residual."""
    if not ex:
        return
    print(f"== executables ({ex.get('compiles')} compiles, "
          f"{_fmt_s(ex.get('compile_s_total'))} compiling, cache "
          f"{ex.get('compile_cache_hits')} hit / "
          f"{ex.get('compile_cache_misses')} miss) ==")
    for r in ex.get("records") or []:
        if r.get("record") == "launch":
            mem = r.get("memory") or {}
            occ = r.get("occupancy") or {}
            cost = r.get("cost") or {}
            bound = cost.get("bound_ms")
            print(f"  {r.get('name', '?'):<14} "
                  f"launches={r.get('launches')} "
                  f"shape={r.get('shape')} fuse={r.get('fuse')} "
                  f"regs={mem.get('registers', '-')} "
                  f"spillB={mem.get('local_bytes', '-')} "
                  f"smemB={mem.get('dynamic_shared_bytes', '-')} "
                  f"blocks/SM={occ.get('blocks_per_sm', '-')} "
                  f"bytes={cost.get('bytes', '-')} "
                  f"flops={cost.get('flops', '-')} "
                  f"bound={'-' if bound is None else f'{bound:.4f}'}ms")
        else:
            print(f"  {r.get('name', '?'):<14} "
                  f"compile={_fmt_s(r.get('compile_s'))} "
                  f"compiler={r.get('compiler', '-')} "
                  f"cache={r.get('cache', '-')}"
                  + (f" error={r['error']}" if r.get("error") else ""))
    coll = ex.get("collectives") or {}
    if coll:
        print("  exchange census per round: " + ", ".join(
            f"{k}={v}" for k, v in sorted(coll.items())))
    proj = ex.get("model_projected_step_us")
    p50 = ex.get("observed_p50_us")
    res = ex.get("model_vs_measured_residual_us")
    if proj is not None or p50 is not None:
        print(f"  model projected {proj}us/step vs observed p50 "
              f"{round(p50, 1) if isinstance(p50, (int, float)) else '-'}"
              f"us -> residual {res}us")


def report_metrics_files(path: str) -> None:
    """Per-process metrics summary from (rank-merged) interval JSONL
    files: the final snapshot's headline counters and the step-latency
    percentiles, attributed per proc."""
    files = rank_files(path)
    if not files:
        return
    print(f"== metrics ({len(files)} file(s)) ==")
    for p in files:
        records = _read_metrics(p)
        if not records:
            continue
        last = records[-1]
        counters = {c.get("name"): c.get("value")
                    for c in last.get("counters", [])}
        line = (f"  proc {last.get('proc')}: "
                f"{len(records)} snapshot(s), steps="
                f"{counters.get('steps')} rounds="
                f"{counters.get('step_rounds')}")
        for h in last.get("histograms", []):
            if h.get("name") == "step_latency_us":
                line += (f", step p50={h.get('p50')}us "
                         f"p99={h.get('p99')}us")
        print(line)


def report_attempts(events) -> None:
    """Per-attempt wall-time attribution from ``attempt_phases``
    journal events (stats ``faults`` section or the event stream)."""
    rows = [e for e in events if e.get("kind") == "attempt_phases"
            or e.get("event") == "attempt_phases"]
    if not rows:
        return
    print("== attempts ==")
    for e in rows:
        attrs = e.get("attrs", e)
        phases = attrs.get("phases_s") or {}
        print(f"  attempt {attrs.get('attempt')}: "
              f"ended as {attrs.get('fault', attrs.get('kind'))} after "
              f"{attrs.get('steps')} steps, "
              f"compute={_fmt_s(phases.get('compute'))}")


def report_tenants(events) -> None:
    """The serve-side story (docs/SERVICE.md): per-tenant job
    timelines distilled from the ``job_*`` lifecycle kinds — submit ->
    packed (batch/slot) -> requeues -> terminal state, with the
    queue-wait and end-to-end latencies that make quota and SLO
    conversations concrete."""
    job_events = [e for e in events
                  if str(e.get("kind", "")).startswith("job_")]
    if not job_events:
        return
    tenants: dict = {}
    for e in job_events:
        attrs = e.get("attrs") or {}
        jid = attrs.get("job", "?")
        tenant = attrs.get("tenant", "?")
        job = tenants.setdefault(tenant, {}).setdefault(jid, {
            "requeues": 0, "status": None, "batch": None,
        })
        kind, ts = e.get("kind"), e.get("ts")
        if kind == "job_submitted":
            job["submitted"] = ts
            job["model"] = attrs.get("model")
            job["L"] = attrs.get("L")
            job["priority"] = attrs.get("priority")
        elif kind == "job_packed":
            job.setdefault("packed", ts)
            job["batch"] = attrs.get("batch")
            job["slot"] = attrs.get("slot")
        elif kind == "job_requeued":
            job["requeues"] += 1
        elif kind == "job_rejected":
            job["status"] = f"rejected({attrs.get('reason')})"
            job["finished"] = ts
        elif kind == "job_complete":
            job["status"] = attrs.get("status")
            job["finished"] = ts
    print("== tenants ==")
    for tenant in sorted(tenants):
        jobs = tenants[tenant]
        done = sum(1 for j in jobs.values()
                   if j.get("status") == "complete")
        print(f"  {tenant}: {len(jobs)} job(s), {done} complete")
        for jid in sorted(jobs):
            j = jobs[jid]
            sub, packed = j.get("submitted"), j.get("packed")
            fin = j.get("finished")
            wait = (f"wait={packed - sub:.3f}s"
                    if packed is not None and sub is not None else "")
            total = (f"total={fin - sub:.3f}s"
                     if fin is not None and sub is not None else "")
            req = (f" requeues={j['requeues']}" if j["requeues"]
                   else "")
            batch = (f" batch={j['batch']}/s{j.get('slot')}"
                     if j.get("batch") else "")
            print(f"    {jid:<10} {j.get('model', '?'):<12} "
                  f"L={j.get('L', '?'):<5} "
                  f"{j.get('status') or 'in-flight':<18}"
                  f"{batch}{req} {wait} {total}")


def report_fleet(events) -> None:
    """The distributed-fleet story (docs/SERVICE.md): membership
    joins/losses, batch fail-overs, and the result cache's
    hit/miss/publish ledger distilled from the (rank-merged) stream —
    the section an operator checks to answer "did the fleet lose a
    member, and did any accepted job go with it?" (the correct answer
    to the second half is always no)."""
    def kind_of(e):
        return e.get("kind") or e.get("event")

    joins = [e for e in events if kind_of(e) == "worker_join"]
    losses = [e for e in events if kind_of(e) == "worker_lost"]
    failovers = [e for e in events if kind_of(e) == "job_failover"]
    hits = [e for e in events if kind_of(e) == "cache_hit"]
    misses = [e for e in events if kind_of(e) == "cache_miss"]
    publishes = [e for e in events if kind_of(e) == "cache_publish"]
    if not (joins or losses or failovers or hits or misses
            or publishes):
        return
    print("== fleet ==")
    roles: dict = {}
    for e in joins:
        role = (e.get("attrs") or {}).get("role", "?")
        roles[role] = roles.get(role, 0) + 1
    role_s = " ".join(f"{r}={n}" for r, n in sorted(roles.items()))
    print(f"  members joined={len(joins)} ({role_s or '-'}) "
          f"lost={len(losses)} job failovers={len(failovers)}")
    for e in losses:
        attrs = e.get("attrs") or {}
        print(f"  lost {attrs.get('worker')}")
    for e in failovers:
        attrs = e.get("attrs") or {}
        print(f"  failover {attrs.get('job')} "
              f"(batch {attrs.get('batch')}) off dead worker "
              f"{attrs.get('worker')}")
    lookups = len(hits) + len(misses)
    rate = f"{100 * len(hits) / lookups:.1f}%" if lookups else "-"
    print(f"  cache: {len(hits)} hit / {len(misses)} miss "
          f"({rate} hit rate), {len(publishes)} publish(es)")
    for e in hits:
        attrs = e.get("attrs") or {}
        print(f"  hit {attrs.get('job')} <- "
              f"{str(attrs.get('digest'))[:12]} "
              f"(tenant {attrs.get('tenant')})")


def report_integrity(events) -> None:
    """The data-integrity story (docs/RESILIENCE.md): detected
    corruptions, replica failovers, and scrub audits distilled from
    the stream — the section an operator checks to answer "did this
    campaign ever serve or survive a corrupt byte?"."""
    def kind_of(e):
        return e.get("kind") or e.get("event")

    corruptions = [e for e in events if kind_of(e) == "corruption"]
    failovers = [e for e in events if kind_of(e) == "replica_failover"]
    scrubs = [e for e in events if kind_of(e) == "scrub"]
    injected = [
        e for e in events
        if kind_of(e) == "injected"
        and (e.get("attrs", e).get("fault")
             or e.get("attrs", e).get("kind"))
        in ("bitflip", "ckpt_corrupt")
    ]
    if not (corruptions or failovers or scrubs or injected):
        return
    audited = sum(
        (e.get("attrs", e).get("steps_audited") or 0) for e in scrubs
    )
    quarantined = sum(
        (e.get("attrs", e).get("corrupt") or 0) for e in scrubs
    )
    print("== integrity ==")
    print(f"  corruption events={len(corruptions)} "
          f"replica failovers={len(failovers)} "
          f"scrub audits={len(scrubs)} "
          f"(steps audited={audited}, quarantined={quarantined}) "
          f"injected faults={len(injected)}")
    for e in corruptions:
        attrs = e.get("attrs", e)
        where = attrs.get("path") or attrs.get("file") or ""
        step = e.get("step", attrs.get("step"))
        print(f"  corruption {'step ' + str(step) + ' ' if step is not None else ''}"
              f"{where}: {attrs.get('detail')}")
    for e in failovers:
        attrs = e.get("attrs", e)
        print(f"  failover {attrs.get('path')} -> {attrs.get('next')} "
              f"({attrs.get('detail')})")


def report_sdc(events) -> None:
    """The compute-path SDC story (resilience/sdc.py,
    docs/RESILIENCE.md "Silent data corruption"): how many redundant-
    compute screens ran, what they caught, which device got the blame,
    and whether anything was quarantined — the section an operator
    checks to answer "did any chip compute a wrong answer?"."""
    def kind_of(e):
        return e.get("kind") or e.get("event")

    def attrs_of(e):
        return e.get("attrs") or e

    checks = [e for e in events if kind_of(e) == "sdc_check"]
    mismatches = [e for e in events if kind_of(e) == "sdc_mismatch"]
    quarantines = [e for e in events
                   if kind_of(e) == "device_quarantined"]
    degraded = [e for e in events if kind_of(e) == "worker_degraded"]
    injected = [
        e for e in events
        if kind_of(e) == "injected"
        and (attrs_of(e).get("fault") or attrs_of(e).get("kind")) == "sdc"
    ]
    if not (checks or mismatches or quarantines or degraded or injected):
        return
    ok = sum(1 for e in checks if attrs_of(e).get("status") == "ok")
    replayed = sum(
        (attrs_of(e).get("replayed_steps") or 0) for e in checks
    )
    modes = sorted({attrs_of(e).get("mode") for e in checks
                    if attrs_of(e).get("mode")})
    print("== sdc ==")
    print(f"  screens={len(checks)} (ok={ok}, "
          f"steps replayed={replayed}"
          f"{', mode ' + '/'.join(modes) if modes else ''}) "
          f"mismatches={len(mismatches)} "
          f"quarantines={len(quarantines)} "
          f"injected faults={len(injected)}")
    for e in mismatches:
        a = attrs_of(e)
        member = a.get("member")
        print(f"  mismatch step {e.get('step', a.get('step'))} "
              f"({a.get('mode')}): device {a.get('device')}"
              f"{', member ' + str(member) if member is not None else ''}"
              f", last verified step {a.get('verified_step')}")
    for e in quarantines:
        a = attrs_of(e)
        print(f"  quarantined {a.get('device')} "
              f"at step {e.get('step', a.get('step'))}: "
              f"{a.get('reason')}")
    for e in degraded:
        a = attrs_of(e)
        print(f"  worker degraded: {a.get('reason')}")


def report_timeline(events, top: int) -> None:
    """The fault/recovery story, oldest first, with relative times —
    one chronological timeline; multi-process streams (rank-merged by
    the caller) get a per-record proc column so every line is
    attributed."""
    interesting = [e for e in events if e.get("kind") not in
                   ("output", "checkpoint", "numerics")]
    if not interesting:
        return
    procs = {e.get("proc") for e in events if e.get("proc") is not None}
    multi = len(procs) > 1
    t0 = interesting[0].get("ts") or 0
    print("== timeline ==")
    for e in interesting:
        attrs = e.get("attrs") or {}
        extra = ""
        if attrs.get("fault"):
            extra += f" fault={attrs['fault']}"
        if attrs.get("action"):
            extra += f" action={attrs['action']}"
        if attrs.get("error"):
            extra += f" error={attrs['error']}"
        if attrs.get("cache"):
            extra += f" cache={attrs['cache']}"
        if attrs.get("tripped"):
            extra += " " + ",".join(
                f"{k}={v:+.3f}" for k, v in attrs["tripped"].items()
            )
        if e.get("kind") == "executable":
            extra += (f" {attrs.get('name')} "
                      f"compile={_fmt_s(attrs.get('compile_s'))}"
                      f" cache={attrs.get('cache', '-')}")
        step = e.get("step")
        proc_col = f"p{e.get('proc', '?')} " if multi else ""
        print(f"  +{(e.get('ts') or t0) - t0:8.3f}s  {proc_col}"
              f"{e.get('kind', '?'):<20} "
              f"{'step ' + str(step) if step is not None else '':<10}"
              f"{extra}")


def report_slow_rounds(doc: dict, top: int) -> None:
    spans = [e for e in doc.get("traceEvents", [])
             if isinstance(e, dict) and e.get("ph") == "X"
             and e.get("name") in ("step_round", "compute", "compile")]
    if not spans:
        return
    spans.sort(key=lambda e: -e["dur"])
    print(f"== slowest rounds (top {top}) ==")
    for e in spans[:top]:
        step = (e.get("args") or {}).get("step")
        print(f"  {e['name']:<12} step={step!s:<8} "
              f"{e['dur'] / 1e3:10.3f}ms at t+{e['ts'] / 1e6:.3f}s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="render gray-scott observability artifacts"
    )
    ap.add_argument("--stats", help="GS_TPU_STATS summary JSON")
    ap.add_argument("--trace", help="GS_TRACE Chrome trace JSON")
    ap.add_argument("--events",
                    help="GS_EVENTS unified stream JSONL (multi-"
                    "process .rank<N> siblings are merged in "
                    "automatically)")
    ap.add_argument("--metrics",
                    help="GS_METRICS interval JSONL (.rank<N> "
                    "siblings merged, summarized per proc)")
    ap.add_argument("--check", action="store_true",
                    help="validate schemas only; no report")
    ap.add_argument("--top", type=int, default=5,
                    help="slowest rounds to list (default 5)")
    args = ap.parse_args(argv)
    if not (args.stats or args.trace or args.events or args.metrics):
        ap.error("need at least one of --stats / --trace / --events "
                 "/ --metrics")
    if args.check:
        return check(args.trace, args.events, args.stats,
                     args.metrics)

    stats = None
    if args.stats:
        with open(args.stats, encoding="utf-8") as f:
            stats = json.load(f)
        report_stats(stats)
    if args.trace:
        with open(args.trace, encoding="utf-8") as f:
            doc = json.load(f)
        problems = validate_trace(doc)
        if problems:
            print(f"gs-report: warning — trace has "
                  f"{len(problems)} schema problem(s)", file=sys.stderr)
        report_slow_rounds(doc, args.top)
    if args.metrics:
        report_metrics_files(args.metrics)
    events = []
    if args.events:
        events = parse_events_multi(args.events)
    elif stats and stats.get("faults"):
        events = stats["faults"]
    if events:
        report_attempts(events)
        report_tenants(events)
        report_fleet(events)
        report_integrity(events)
        report_sdc(events)
        report_timeline(events, args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
