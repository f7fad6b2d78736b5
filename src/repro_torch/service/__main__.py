"""Command line of the port's DSE service.

    python -m repro_torch.service explore jobs.json --stream
    python -m repro_torch.service explore jobs.json --json
    python -m repro_torch.service explore jobs.json --url http://host:8731
    python -m repro_torch.service serve --host 0.0.0.0 --port 8731
    python -m repro_torch.service serve --port 0 --port-file port.txt
    python -m repro_torch.service stats --url http://host:8731
    python -m repro_torch.service store --info
    python -m repro_torch.service store --clear
    python -m repro_torch.service trace --export chrome -o trace.json
    python -m repro_torch.service timeline <job-key> --url http://host:8731
    python -m repro_torch.service profile [--kernels A,B] [--repeats N]
    python -m repro_torch.service calibrate -o calibration.json [--json]

Every subcommand that runs work (``explore``, ``serve``, ``stats``,
``profile``, ``calibrate``) runs on the CUDA card unless ``--device cpu``
asks for the kernels' plain versions on the CPU; against ``--url`` the
server's device kind must match it.  ``calibrate`` writes an artifact
that ``CIM_TUNER_CALIBRATION`` pins (the reference's schema, so either
package reads it).

``jobs.json`` is a list of job specs (see
:func:`repro_torch.service.client.job_from_spec`)::

    [{"macro": "vanilla-dcim", "workload": "bert-large",
      "area_budget_mm2": 5.0, "objective": "ee", "search": "exhaustive"},
     {"macro": "tpdcim-macro", "workload": {"name": "yi-6b", "seq": 512},
      "area_budget_mm2": 2.23, "objective": "th", "search": "portfolio"}]

Each spec's ``"search"`` key picks the optimizer per job: any registered
``repro_torch.search`` backend ("sa", "genetic", "evolution", "sobol",
"portfolio") or "exhaustive" as a plain name, or the structured per-job
form ``{"method": "portfolio", "settings": {"total_evals": 8000},
"allocator": "bandit"}`` (a top-level ``"settings"`` dict is the legacy
spelling).  ``explore --search NAME`` overrides every spec's backend;
``--search-settings '{"total_evals": 8000}'`` merges a JSON dict over
every spec's backend settings.  With ``--stream`` each result line
prints the moment its micro-batch bucket finishes (completion order);
without it, results print in submission order once all are done.

``explore``/``stats`` run against a remote ``serve`` instance when
``--url`` (or the ``CIM_TUNER_SERVICE_URL`` environment variable) points
at one -- CI fleets and multi-host sweeps share that server's engine and
result store instead of each running their own.  The URL must serve the
port: a reference server there is an error, never a silent detour.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time


def _resolved_url(args) -> str | None:
    return args.url or os.environ.get("CIM_TUNER_SERVICE_URL") or None


def _cmd_explore(args) -> int:
    from repro_torch.service import ServiceClient, serialize_result

    with open(args.jobs_file) as f:
        specs = json.load(f)
    if not isinstance(specs, list) or not specs:
        print("error: jobs file must be a non-empty JSON list",
              file=sys.stderr)
        return 2
    if args.search:
        # override drops any structured search dict (its settings belong
        # to the replaced backend); --search-settings can re-supply knobs
        specs = [{**spec, "search": args.search} for spec in specs]
        for spec in specs:
            spec.pop("settings", None)
    if args.search_settings:
        from repro_torch.service import merge_spec_settings
        try:
            override = json.loads(args.search_settings)
            if not isinstance(override, dict):
                raise ValueError("must be a JSON object")
            # raises on ambiguous specs (settings in both spellings)
            specs = [merge_spec_settings(spec, override) for spec in specs]
        except ValueError as exc:
            print(f"error: bad --search-settings: {exc}", file=sys.stderr)
            return 2
    # validate every spec (including the --search/--search-settings
    # overrides) up front, so a typo'd backend name or settings field
    # fails fast with a clean error, not a traceback out of the running
    # service
    from repro_torch.service import job_from_spec
    try:
        for spec in specs:
            job_from_spec(spec)
    except (KeyError, TypeError, ValueError) as exc:
        print(f"error: bad job spec: {exc}", file=sys.stderr)
        return 2

    try:
        svc = ServiceClient(store=None if args.no_store else "auto",
                            base_url=_resolved_url(args), device=args.device)
    except (ConnectionError, RuntimeError, ValueError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    t0 = time.perf_counter()

    def emit(i, result):
        dt = time.perf_counter() - t0
        cache = result.search.get("cache")
        if args.json:
            rec = {"index": i, "elapsed_s": round(dt, 3),
                   "source": cache or "engine",
                   "result": serialize_result(result)}
            print(json.dumps(rec), flush=True)
        else:
            src = f" [{cache}]" if cache else ""
            print(f"[{dt:7.2f}s] #{i} {result.summary()}{src}", flush=True)

    try:
        if args.stream:
            for i, result in svc.explore_specs(specs, stream=True):
                emit(i, result)
        else:
            for i, result in enumerate(svc.explore_specs(specs)):
                emit(i, result)
    finally:
        svc.close()
    if not args.json:
        print(f"# {len(specs)} jobs in {time.perf_counter()-t0:.2f}s "
              f"(stats: {svc.stats})", flush=True)
    return 0


def _cmd_serve(args) -> int:
    from repro_torch.service.server import DSEServer, ServerConfig

    cfg = ServerConfig(host=args.host, port=args.port, quiet=not args.verbose)
    try:
        server = DSEServer(store=None if args.no_store else "auto",
                           config=cfg, device=args.device)
    except (RuntimeError, ValueError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    server.start()
    health = server.health()
    print(f"serving on {server.url} (device {health['device']}, "
          f"{health['dtype']})", flush=True)
    if args.port_file:
        with open(args.port_file, "w") as f:
            f.write(str(server.port))
    stop = threading.Event()
    if threading.current_thread() is threading.main_thread():
        # signal handlers can only be installed from the main thread
        for sig in (signal.SIGINT, signal.SIGTERM):
            signal.signal(sig, lambda *_: stop.set())
    try:
        while not stop.is_set():       # short waits keep signals prompt
            stop.wait(1.0)
    finally:
        print("draining in-flight buckets ...", flush=True)
        server.shutdown(drain=True)
        print(f"stopped ({server.http_stats['requests']} requests served)",
              flush=True)
    return 0


def _cmd_stats(args) -> int:
    from repro_torch.service import ServiceClient, default_service

    url = _resolved_url(args)
    try:
        svc = ServiceClient(base_url=url, store=None, device=args.device) \
            if url else default_service(args.device)
    except (ConnectionError, RuntimeError, ValueError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    print(json.dumps(svc.stats_snapshot(), indent=2))
    return 0


def _cmd_trace(args) -> int:
    from repro_torch import obs

    events: list = []
    if args.url or (not args.input and os.environ.get(
            "CIM_TUNER_SERVICE_URL") and not os.environ.get(
            "CIM_TUNER_TRACE")):
        # live ring buffer of a running serve instance
        import urllib.request
        url = (args.url or os.environ["CIM_TUNER_SERVICE_URL"]).rstrip("/")
        with urllib.request.urlopen(f"{url}/v1/trace", timeout=30) as resp:
            doc = json.loads(resp.read().decode("utf-8"))
        events = doc.get("traceEvents", [])
    else:
        path = args.input or os.environ.get("CIM_TUNER_TRACE")
        if not path:
            print("error: no trace source -- pass --input FILE / --url URL "
                  "or set CIM_TUNER_TRACE", file=sys.stderr)
            return 2
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        events.append(json.loads(line))
        except (OSError, ValueError) as exc:
            print(f"error: cannot read trace {path!r}: {exc}",
                  file=sys.stderr)
            return 2

    if args.export == "chrome":
        out = args.output or "trace.json"
        with open(out, "w") as f:
            json.dump(obs.chrome_trace(events), f)
        print(f"wrote {len(events)} spans to {out} "
              f"(load in Perfetto / chrome://tracing)")
    else:                                              # jsonl
        stream = open(args.output, "w") if args.output else sys.stdout
        try:
            for ev in events:
                stream.write(json.dumps(ev) + "\n")
        finally:
            if args.output:
                stream.close()
                print(f"wrote {len(events)} spans to {args.output}")
    return 0


def _cmd_timeline(args) -> int:
    from repro_torch.obs.recorder import render_timeline

    url = _resolved_url(args)
    timeline = None
    if url:
        import urllib.error
        import urllib.request
        endpoint = f"{url.rstrip('/')}/v1/jobs/{args.key}/timeline"
        try:
            with urllib.request.urlopen(endpoint, timeout=30) as resp:
                doc = json.loads(resp.read().decode("utf-8"))
            timeline = doc.get("timeline")
        except urllib.error.HTTPError as exc:
            if exc.code != 404:
                raise
    else:
        from repro_torch.service import default_store
        store = default_store()
        timeline = store.get_timeline(args.key) \
            if store is not None else None
    if timeline is None:
        print(f"error: no timeline for job {args.key!r}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(timeline, indent=2, sort_keys=True))
    else:
        print(render_timeline(timeline))
    return 0


def _cmd_profile(args) -> int:
    os.environ["CIM_TUNER_PROFILE"] = "1"
    from repro_torch import obs

    kernels = [k for k in (args.kernels or "").split(",") if k] or None
    try:
        records = obs.profile.run_microbench(kernels=kernels,
                                             repeats=args.repeats,
                                             device=args.device)
    except (ValueError, RuntimeError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    rows = obs.profile.summary(records)
    if args.json:
        print(json.dumps(rows, indent=2))
    else:
        print(f"{'kernel':<16} {'bucket':<18} {'calls':>6} "
              f"{'us/call':>12} {'flops':>12} {'bytes':>12} {'roofline':>9}")
        for r in rows:
            print(f"{r['kernel']:<16} {r['bucket']:<18} "
                  f"{r['calls']:>6} {r['us_per_call']:>12.1f} "
                  f"{r['flops']:>12.3g} {r['bytes']:>12.3g} "
                  f"{r['roofline_utilization']:>9.2e}")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(obs.registry().render())
        print(f"# wrote metrics exposition to {args.metrics_out}",
              file=sys.stderr)
    return 0


def _cmd_calibrate(args) -> int:
    """Measure -> fit -> (optionally) pin: the calibration tier's CLI.

    Runs the kernel microbench sweep (or reads measurements from a prior
    artifact via ``--input``), fits correction factors with a held-out
    split, prints the fit report, and writes a calibration artifact that
    ``CIM_TUNER_CALIBRATION`` can pin."""
    from repro_torch.core import calibration as cal

    if args.input:
        try:
            _cf, payload = cal.load_calibration(args.input)
            records = payload.get("measurements") or []
            if not records:
                raise ValueError("artifact carries no measurements")
        except (OSError, ValueError) as exc:
            print(f"error: cannot reuse {args.input!r}: {exc}",
                  file=sys.stderr)
            return 2
    else:
        from repro_torch import obs
        kernels = [k for k in (args.kernels or "").split(",") if k] or None
        try:
            records = obs.run_microbench(kernels=kernels,
                                         repeats=args.repeats,
                                         seed=args.seed, device=args.device)
        except (ValueError, RuntimeError) as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 2
    try:
        report = cal.fit_report(records, holdout_fraction=args.holdout,
                                seed=args.seed)
        corrections = cal.fit_corrections(records)
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    payload = None
    if args.output:
        payload = cal.save_calibration(args.output, corrections,
                                       records=records, report=report)
    if args.json:
        out = {"records": len(records), "report": report,
               "corrections": corrections.as_dict(),
               "version": cal.calibration_version(corrections)}
        if args.output:
            out["artifact"] = args.output
        print(json.dumps(out, indent=2))
        return 0
    print(f"measurements : {len(records)} records")
    print(f"corrections  : compute={corrections.compute:.4g} "
          f"memory={corrections.memory:.4g} "
          f"update={corrections.update:.4g}")
    print(f"version      : {cal.calibration_version(corrections)}")
    print(f"holdout RMS  : uncalibrated "
          f"{report['uncalibrated_rms_us']:.2f}us -> calibrated "
          f"{report['calibrated_rms_us']:.2f}us "
          f"(improvement {report['improvement']:.2f}x)")
    if payload is not None:
        print(f"artifact     : {args.output}  "
              f"(pin with {cal.CALIBRATION_ENV}={args.output})")
    return 0


def _cmd_store(args) -> int:
    from repro_torch.service import default_store

    store = default_store()
    if store is None:
        print("result store disabled (CIM_TUNER_DISABLE_RESULT_STORE)")
        return 0
    if args.clear:
        print(f"cleared {store.clear()} records from {store.root}")
        return 0
    keys = store.keys()
    print(f"store root : {store.root}")
    print(f"records    : {len(keys)}")
    for k in keys[:20]:
        print(f"  {k}")
    if len(keys) > 20:
        print(f"  ... {len(keys) - 20} more")
    return 0


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="cuda (default: the card's kernels) or cpu (the "
                        "kernels' plain versions)")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.service",
        description="DSE service over the PyTorch port's batched "
                    "exploration engine, and its kernel calibration tier")
    sub = ap.add_subparsers(dest="cmd", required=True)

    ex = sub.add_parser("explore", help="run a JSON job file")
    ex.add_argument("jobs_file")
    ex.add_argument("--stream", action="store_true",
                    help="print each result as its bucket finishes")
    ex.add_argument("--json", action="store_true",
                    help="machine-readable JSONL output")
    ex.add_argument("--no-store", action="store_true",
                    help="bypass the persistent result store")
    ex.add_argument("--search", default=None, metavar="BACKEND",
                    help="override every spec's search backend (sa, "
                         "genetic, evolution, sobol, portfolio, "
                         "exhaustive)")
    ex.add_argument("--search-settings", default=None, metavar="JSON",
                    help="JSON dict merged over every spec's backend "
                         "settings, e.g. "
                         "'{\"total_evals\": 8000, \"allocator\": "
                         "\"bandit\"}'")
    ex.add_argument("--url", default=None, metavar="URL",
                    help="submit to a running port `serve` instance "
                         "(default: $CIM_TUNER_SERVICE_URL, else "
                         "in-process)")
    _add_device(ex)
    ex.set_defaults(fn=_cmd_explore)

    sv = sub.add_parser("serve",
                        help="run the multi-process HTTP front door")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8731,
                    help="0 binds an ephemeral port (printed on startup)")
    sv.add_argument("--port-file", default=None, metavar="PATH",
                    help="write the bound port here (CI scripting)")
    sv.add_argument("--no-store", action="store_true",
                    help="serve without a persistent result store")
    sv.add_argument("--verbose", action="store_true",
                    help="per-request access logging on stderr")
    _add_device(sv)
    sv.set_defaults(fn=_cmd_serve)

    st = sub.add_parser("stats", help="print service counters as JSON")
    st.add_argument("--url", default=None, metavar="URL",
                    help="query a remote serve instance "
                         "(default: $CIM_TUNER_SERVICE_URL)")
    _add_device(st)
    st.set_defaults(fn=_cmd_stats)

    so = sub.add_parser("store", help="inspect / clear the result store")
    so.add_argument("--info", action="store_true", default=True)
    so.add_argument("--clear", action="store_true")
    so.set_defaults(fn=_cmd_store)

    tr = sub.add_parser(
        "trace", help="export the span trace buffer "
                      "(Chrome trace_event / JSONL)")
    tr.add_argument("--input", default=None, metavar="FILE",
                    help="JSONL trace file written via CIM_TUNER_TRACE "
                         "(default: $CIM_TUNER_TRACE)")
    tr.add_argument("--url", default=None, metavar="URL",
                    help="fetch the live ring buffer from a running "
                         "serve instance (GET /v1/trace)")
    tr.add_argument("--export", choices=("chrome", "jsonl"),
                    default="chrome",
                    help="chrome: Perfetto-loadable trace.json (default); "
                         "jsonl: raw span lines")
    tr.add_argument("-o", "--output", default=None, metavar="PATH",
                    help="output file (chrome default: trace.json; "
                         "jsonl default: stdout)")
    tr.set_defaults(fn=_cmd_trace)

    tl = sub.add_parser(
        "timeline", help="render one job's search decision timeline "
                         "(regret-vs-budget curve + convergence summary)")
    tl.add_argument("key", help="canonical job key")
    tl.add_argument("--url", default=None, metavar="URL",
                    help="fetch GET /v1/jobs/<key>/timeline from a "
                         "running serve instance (default: "
                         "$CIM_TUNER_SERVICE_URL, else the local store)")
    tl.add_argument("--json", action="store_true",
                    help="print the raw timeline record instead of the "
                         "rendered view")
    tl.set_defaults(fn=_cmd_timeline)

    pr = sub.add_parser(
        "profile", help="run the kernel micro-profile pass "
                        "(cim_kernel_us / roofline utilization)")
    pr.add_argument("--kernels", default=None, metavar="A,B",
                    help="comma-separated kernel subset (default: all of "
                         "cim_matmul, flash_attention, selective_scan, "
                         "strategy_eval)")
    pr.add_argument("--repeats", type=int, default=3,
                    help="profiled calls per kernel (default 3)")
    pr.add_argument("--json", action="store_true",
                    help="machine-readable summary rows")
    pr.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="also dump the Prometheus exposition here")
    _add_device(pr)
    pr.set_defaults(fn=_cmd_profile)

    ca = sub.add_parser(
        "calibrate", help="fit measured-kernel correction factors and "
                          "write a calibration artifact")
    ca.add_argument("--kernels", default=None, metavar="A,B",
                    help="comma-separated kernel subset to microbench "
                         "(default: all)")
    ca.add_argument("--repeats", type=int, default=3,
                    help="timed calls per kernel/tiling case (default 3)")
    ca.add_argument("--seed", type=int, default=0,
                    help="seed for microbench inputs and the held-out "
                         "split (default 0)")
    ca.add_argument("--input", default=None, metavar="PATH",
                    help="refit from the measurements stored in an "
                         "existing artifact instead of re-running the "
                         "microbench")
    ca.add_argument("--holdout", type=float, default=0.25,
                    help="held-out fraction for the fit report "
                         "(default 0.25)")
    ca.add_argument("-o", "--output", default=None, metavar="PATH",
                    help="write the calibration artifact here (pin it "
                         "via CIM_TUNER_CALIBRATION)")
    ca.add_argument("--json", action="store_true",
                    help="machine-readable report")
    _add_device(ca)
    ca.set_defaults(fn=_cmd_calibrate)

    args = ap.parse_args(argv)
    from repro_torch.obs import configure_logging
    configure_logging()                    # honour CIM_TUNER_LOG in CLIs
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
