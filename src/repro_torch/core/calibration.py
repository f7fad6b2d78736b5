"""Silicon-calibrated technology constants and the measured calibration
tier of the CIM-Tuner PPA models.

The port's copy of the reference's ``core/calibration.py``.  The constants
are fitted so the two SOTA baselines of Table II land at their published
areas:

    TranCIM-Base  (MR,MC,SCR,IS,OS) = (3,1,1,64,128)  ->  3.52 mm^2
    TP-DCIM-Base  (MR,MC,SCR,IS,OS) = (2,4,1,16,16)   ->  2.23 mm^2

and, on Bert-large, at their published TOPS/W (2.54 / 1.89).

The second half is the paper's *measurement* loop (Sec. IV-E):
:func:`fit_corrections` solves per-term :class:`CorrectionFactors` from
measured kernel timings (``repro_torch.obs.profile.run_microbench``, on
the card), :meth:`TechConstants.with_corrections` applies them, and
:class:`CostModel` is the one facade every consumer reaches the calibrated
(or analytic) constants through.  Corrections scale ONLY the
energy/leakage constants -- the area model (and therefore feasibility and
pruning) is untouched, so a calibrated re-score ranks the same feasible
set the analytic search explored.  Artifacts use the reference's schema,
so either package reads the other's.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import random
import threading
import typing

#: environment variable naming a pinned calibration artifact
#: (written by ``python -m repro_torch.service calibrate -o ...`` /
#: :func:`save_calibration`)
CALIBRATION_ENV = "CIM_TUNER_CALIBRATION"

#: bump when the calibration artifact layout changes meaning
CALIBRATION_SCHEMA = 1


@dataclasses.dataclass(frozen=True)
class TechConstants:
    """28 nm-class energy/area/leakage constants (pJ, mm^2, mW)."""

    # --- per-instruction energies (pJ) -----------------------------------
    e_mac_pj: float = 0.08            # one INT8 MAC inside a DCIM macro
    e_sram_rd_pj_bit: float = 0.12    # IS/OS SRAM read, per bit
    e_sram_wr_pj_bit: float = 0.14    # IS/OS SRAM write, per bit
    e_cim_update_pj_bit: float = 0.20 # CIM weight-update write path, per bit
    e_ema_pj_bit: float = 1.2         # external memory interface, per bit
    # System-level overhead multiplier on dynamic energy (controller, clock
    # tree, NoC) -- folds the parts of PTPX power the template cannot see.
    sys_energy_overhead: float = 1.3

    # --- leakage ----------------------------------------------------------
    p_leak_mw_mm2: float = 15.0       # leakage power density

    # --- area (um^2 unless noted) ----------------------------------------
    a_cell_um2_bit: float = 0.36      # 6T bit-cell + CIM overhead, per bit
    a_cu_um2: float = 497.0           # one 8b MAC compute unit (fitted)
    a_sram_mm2_per_mb: float = 0.25   # compiled SRAM density
    a_sram_fixed_mm2: float = 0.02    # per-SRAM-instance periphery
    a_macro_fixed_mm2: float = 0.01   # per-macro periphery (drivers, ctrl)
    a_fixed_mm2: float = 0.0          # absorbed into per-macro/SRAM fixed (fit)

    # --- timing -----------------------------------------------------------
    freq_mhz: float = 500.0           # default operating frequency

    # --- data widths (bits) -----------------------------------------------
    dw_in: int = 8
    dw_w: int = 8
    dw_psum: int = 24
    dw_out: int = 8

    def with_corrections(
        self, corrections: "CorrectionFactors | None",
    ) -> "TechConstants":
        """A copy with measured correction factors applied.

        ``compute`` scales the per-MAC energy, ``memory`` scales every
        SRAM/external-interface per-bit energy, ``update`` scales the CIM
        weight-update path and ``leakage`` scales leakage density.  Area
        constants are deliberately NOT touched: feasibility, pruning and
        the snap-verify area check must agree between the analytic and
        calibrated fidelities.  Identity corrections (or ``None``) return
        ``self`` unchanged, bit-for-bit -- so analytic job keys and
        executable-cache entries are unaffected.
        """
        if corrections is None or corrections.is_identity():
            return self
        c = corrections
        return dataclasses.replace(
            self,
            e_mac_pj=self.e_mac_pj * c.compute,
            e_sram_rd_pj_bit=self.e_sram_rd_pj_bit * c.memory,
            e_sram_wr_pj_bit=self.e_sram_wr_pj_bit * c.memory,
            e_ema_pj_bit=self.e_ema_pj_bit * c.memory,
            e_cim_update_pj_bit=self.e_cim_update_pj_bit * c.update,
            p_leak_mw_mm2=self.p_leak_mw_mm2 * c.leakage,
        )


DEFAULT_TECH = TechConstants()


def resolve_tech(tech: "TechConstants | None" = None) -> TechConstants:
    """THE default-tech rule, in one place: an explicit ``tech`` wins,
    ``None`` means the analytic :data:`DEFAULT_TECH`.  Every module that
    used to spell ``tech=DEFAULT_TECH`` in its signature now spells
    ``tech=None`` and resolves here, so calibrated technologies enter
    through :class:`CostModel` / :meth:`TechConstants.with_corrections`
    only -- never ambiently via an environment variable."""
    return tech if tech is not None else DEFAULT_TECH


# --------------------------------------------------------------------- #
# measured correction factors
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class CorrectionFactors:
    """Per-term multipliers fitted from measured kernel timings.

    The fit model is a two-term roofline in microseconds::

        t_us ~ compute * (flops / peak_flops) * 1e6
             + memory  * (bytes / peak_bw)    * 1e6

    ``update`` rides the memory term (CIM updates are write traffic) and
    ``leakage`` stays 1.0 -- the microbench cannot observe static power.
    ``fitted_on`` / ``residual_us`` are diagnostics of the fit that
    produced the factors (0 / 0.0 for hand-built factors).
    """

    compute: float = 1.0
    memory: float = 1.0
    update: float = 1.0
    leakage: float = 1.0
    fitted_on: int = 0                # measurement records used by the fit
    residual_us: float = 0.0          # RMS error of the fit on its train set

    def is_identity(self) -> bool:
        """True when applying these factors is a no-op."""
        return (self.compute == 1.0 and self.memory == 1.0
                and self.update == 1.0 and self.leakage == 1.0)

    def as_dict(self) -> dict:
        """JSON-able field dict (the artifact / HTTP payload form)."""
        return dataclasses.asdict(self)


def calibration_version(
    corrections: CorrectionFactors | None,
) -> str:
    """Stable content hash of a set of correction factors.

    ``"uncalibrated"`` for ``None``/identity; otherwise a 16-hex-digit
    digest over the factor floats (hex-encoded, so the version is
    bit-exact, not repr-approximate).  Folded into ``job_key`` for
    measured-fidelity jobs, so warm analytic results never answer
    calibrated queries and two differently-calibrated runs never share
    a store record.
    """
    if corrections is None or corrections.is_identity():
        return "uncalibrated"
    payload = {
        "schema": CALIBRATION_SCHEMA,
        "factors": [float(x).hex() for x in (
            corrections.compute, corrections.memory,
            corrections.update, corrections.leakage)],
    }
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


# --------------------------------------------------------------------- #
# the fitting pass
# --------------------------------------------------------------------- #
def _features(record: typing.Mapping) -> tuple[float, float] | None:
    """(compute_us, memory_us) roofline features of one measurement
    record, or ``None`` when the record carries no work counts."""
    flops = record.get("flops")
    nbytes = record.get("bytes")
    if not flops and not nbytes:
        return None
    from repro_torch.obs import profile as _profile

    t_c = float(flops or 0.0) / _profile.peak_flops() * 1e6
    t_m = float(nbytes or 0.0) / _profile.peak_bw() * 1e6
    return t_c, t_m


def _usable(records: typing.Iterable[typing.Mapping]) -> list[tuple[
        float, float, float]]:
    rows = []
    for r in records:
        feats = _features(r)
        if feats is None or r.get("us") is None:
            continue
        rows.append((feats[0], feats[1], float(r["us"])))
    return rows


_FACTOR_MIN, _FACTOR_MAX = 1e-3, 1e3


def _clamp(x: float) -> float:
    if not math.isfinite(x) or x <= 0.0:
        return 1.0
    return min(max(x, _FACTOR_MIN), _FACTOR_MAX)


def fit_corrections(
    records: typing.Sequence[typing.Mapping],
) -> CorrectionFactors:
    """Least-squares fit of :class:`CorrectionFactors` from measurement
    records (the :class:`repro_torch.obs.profile.MeasurementRecord` schema:
    ``kernel, bucket, tiling, us, flops, bytes, seed``).

    Solves the 2x2 normal equations of ``us ~ compute*t_c + memory*t_m``;
    a singular/ill-conditioned system falls back to independent per-term
    1-D fits.  Factors are clamped to ``[1e-3, 1e3]``; ``update`` follows
    ``memory`` (CIM updates are write traffic) and ``leakage`` stays 1.0.
    Raises ``ValueError`` when no record carries both a timing and work
    counts.
    """
    rows = _usable(records)
    if not rows:
        raise ValueError(
            "no usable measurement records (need 'us' plus a "
            "flops/bytes work count)")
    s_cc = sum(tc * tc for tc, _tm, _us in rows)
    s_mm = sum(tm * tm for _tc, tm, _us in rows)
    s_cm = sum(tc * tm for tc, tm, _us in rows)
    s_cy = sum(tc * us for tc, _tm, us in rows)
    s_my = sum(tm * us for _tc, tm, us in rows)
    det = s_cc * s_mm - s_cm * s_cm
    # relative-determinant test: collinear features (every kernel at the
    # same flops:bytes ratio) make the joint solve meaningless
    if det > 1e-12 * max(s_cc * s_mm, 1e-300):
        compute = (s_cy * s_mm - s_my * s_cm) / det
        memory = (s_my * s_cc - s_cy * s_cm) / det
    else:                                      # fall back to 1-D solves
        compute = s_cy / s_cc if s_cc > 0.0 else 1.0
        memory = s_my / s_mm if s_mm > 0.0 else 1.0
    compute, memory = _clamp(compute), _clamp(memory)
    fitted = dataclasses.replace(
        CorrectionFactors(), compute=compute, memory=memory, update=memory,
        fitted_on=len(rows))
    return dataclasses.replace(
        fitted, residual_us=evaluate_corrections(records, fitted))


def predict_us(record: typing.Mapping,
               corrections: CorrectionFactors | None = None) -> float | None:
    """Model-predicted kernel time (us) for one measurement record;
    ``None`` when the record has no work counts.  ``corrections=None``
    is the *uncalibrated* roofline prediction (both factors 1.0)."""
    feats = _features(record)
    if feats is None:
        return None
    c = corrections or CorrectionFactors()
    return c.compute * feats[0] + c.memory * feats[1]


def evaluate_corrections(
    records: typing.Sequence[typing.Mapping],
    corrections: CorrectionFactors | None = None,
) -> float:
    """RMS error (us) of the (possibly uncalibrated) model over the
    records' measured timings."""
    rows = _usable(records)
    if not rows:
        raise ValueError("no usable measurement records to evaluate")
    c = corrections or CorrectionFactors()
    sq = 0.0
    for tc, tm, us in rows:
        err = c.compute * tc + c.memory * tm - us
        sq += err * err
    return math.sqrt(sq / len(rows))


def fit_report(
    records: typing.Sequence[typing.Mapping],
    holdout_fraction: float = 0.25,
    seed: int = 0,
) -> dict:
    """Fit on a deterministic train split, score on the held-out rest.

    Returns a JSON-able report::

        {"corrections": {...}, "version": ..., "train_records": N,
         "holdout_records": M, "uncalibrated_rms_us": ...,
         "calibrated_rms_us": ..., "improvement": ...}

    ``calibrated_rms_us`` is the fitted model's error on the HELD-OUT
    records; ``uncalibrated_rms_us`` is the identity model's error on the
    same records, so ``improvement > 1`` means the fit generalizes.  With
    fewer than 3 usable records the whole set is both train and holdout.
    """
    usable = [r for r in records
              if _features(r) is not None and r.get("us") is not None]
    if not usable:
        raise ValueError("no usable measurement records to fit")
    order = list(range(len(usable)))
    random.Random(seed).shuffle(order)
    n_hold = max(1, int(len(usable) * holdout_fraction))
    if len(usable) - n_hold < 2:                # tiny sets: no split
        train = holdout = usable
        n_hold = len(usable)
    else:
        hold_ix = set(order[:n_hold])
        train = [r for i, r in enumerate(usable) if i not in hold_ix]
        holdout = [r for i, r in enumerate(usable) if i in hold_ix]
    corrections = fit_corrections(train)
    uncal = evaluate_corrections(holdout)
    cal = evaluate_corrections(holdout, corrections)
    return {
        "corrections": corrections.as_dict(),
        "version": calibration_version(corrections),
        "train_records": len(train),
        "holdout_records": len(holdout),
        "uncalibrated_rms_us": uncal,
        "calibrated_rms_us": cal,
        "improvement": (uncal / cal) if cal > 0.0 else math.inf,
    }


# --------------------------------------------------------------------- #
# calibration artifacts (the CIM_TUNER_CALIBRATION pin)
# --------------------------------------------------------------------- #
def save_calibration(
    path: str,
    corrections: CorrectionFactors,
    records: typing.Sequence[typing.Mapping] | None = None,
    report: dict | None = None,
) -> dict:
    """Write a calibration artifact (atomic JSON) and return its payload.

    The artifact pins a fitted model: point :data:`CALIBRATION_ENV` at it
    and every measured-fidelity consumer in the fleet shares one
    calibration version (hence one set of store keys)."""
    payload = {
        "schema": CALIBRATION_SCHEMA,
        "version": calibration_version(corrections),
        "corrections": corrections.as_dict(),
    }
    if report is not None:
        payload["report"] = {k: v for k, v in report.items()
                             if k != "corrections"}
    if records is not None:
        payload["measurements"] = [dict(r) for r in records]
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return payload


def load_calibration(path: str) -> tuple[CorrectionFactors, dict]:
    """Read an artifact written by :func:`save_calibration`; returns the
    parsed :class:`CorrectionFactors` plus the raw payload."""
    with open(path) as f:
        payload = json.load(f)
    if payload.get("schema") != CALIBRATION_SCHEMA:
        raise ValueError(
            f"calibration artifact {path!r} has schema "
            f"{payload.get('schema')!r}, expected {CALIBRATION_SCHEMA}")
    fields = {f.name for f in dataclasses.fields(CorrectionFactors)}
    raw = payload.get("corrections") or {}
    cf = CorrectionFactors(**{k: v for k, v in raw.items() if k in fields})
    return cf, payload


# --------------------------------------------------------------------- #
# live calibration state (process-cached)
# --------------------------------------------------------------------- #
_cal_lock = threading.Lock()
_live_fit: tuple[CorrectionFactors, list] | None = None
_env_artifact: tuple[str, CorrectionFactors, dict] | None = None


def _pinned_artifact() -> tuple[CorrectionFactors, dict] | None:
    """The :data:`CALIBRATION_ENV` artifact, if set and loadable
    (re-read when the env var changes; unreadable pins are ignored so a
    stale path degrades to live fitting rather than failing the job)."""
    global _env_artifact
    path = os.environ.get(CALIBRATION_ENV)
    if not path:
        _env_artifact = None
        return None
    if _env_artifact is not None and _env_artifact[0] == path:
        return _env_artifact[1], _env_artifact[2]
    try:
        cf, payload = load_calibration(path)
    except (OSError, ValueError, TypeError):
        return None
    _env_artifact = (path, cf, payload)
    return cf, payload


def resolve_corrections() -> tuple[CorrectionFactors, str, list]:
    """The corrections a measured-fidelity run should apply, with
    provenance: ``(factors, source, measurement_records)``.

    Precedence: a pinned :data:`CALIBRATION_ENV` artifact
    (``source="artifact"``; its stored measurements ride along), else a
    process-cached live fit over a fresh
    :func:`repro_torch.obs.profile.run_microbench` sweep (``source="live"``).
    The live fit runs the kernels ONCE per process -- repeated measured
    races reuse it."""
    global _live_fit
    with _cal_lock:
        pinned = _pinned_artifact()
        if pinned is not None:
            cf, payload = pinned
            return cf, "artifact", list(payload.get("measurements") or ())
        if _live_fit is None:
            from repro_torch.obs import profile as _profile

            records = _profile.run_microbench()
            try:
                cf = fit_corrections(records)
            except ValueError:
                # no usable records: degrade to identity so the measured
                # phase still re-scores -- with uncorrected constants
                cf = CorrectionFactors()
            _live_fit = (cf, list(records))
        return _live_fit[0], "live", list(_live_fit[1])


def active_calibration_version() -> str:
    """The version string folded into measured-fidelity job keys.

    A pinned artifact answers with its stored version (stable across
    processes/hosts -- pin one artifact fleet-wide for shared store
    keys); an already-run live fit answers with its fitted version; a
    process that has not measured yet answers the ``"live"`` sentinel
    (submission-time keys must not trigger a kernel sweep)."""
    with _cal_lock:
        pinned = _pinned_artifact()
        if pinned is not None:
            return calibration_version(pinned[0])
        if _live_fit is not None:
            return calibration_version(_live_fit[0])
    return "live"


def calibration_record() -> dict:
    """JSON-able view of the process's active calibration (the
    ``calibrate`` subcommand's summary): source, version, factors, and fit diagnostics when
    available."""
    with _cal_lock:
        pinned = _pinned_artifact()
        if pinned is not None:
            cf, payload = pinned
            out = {
                "source": "artifact",
                "path": os.environ.get(CALIBRATION_ENV),
                "version": calibration_version(cf),
                "corrections": cf.as_dict(),
            }
            if "report" in payload:
                out["report"] = payload["report"]
            return out
        if _live_fit is not None:
            cf = _live_fit[0]
            return {
                "source": "live",
                "version": calibration_version(cf),
                "corrections": cf.as_dict(),
                "measurements": len(_live_fit[1]),
            }
    return {"source": "none", "version": "uncalibrated"}


def reset_calibration_state() -> None:
    """Forget the cached live fit and pinned-artifact read (tests /
    re-pointing :data:`CALIBRATION_ENV`)."""
    global _live_fit, _env_artifact
    with _cal_lock:
        _live_fit = None
        _env_artifact = None
    reset_default_cost_model()


# --------------------------------------------------------------------- #
# the CostModel facade
# --------------------------------------------------------------------- #
class CostModel:
    """ONE front door to the PPA models: base constants + corrections.

    ``CostModel()`` is the analytic model on :data:`DEFAULT_TECH`;
    ``CostModel(corrections=...)`` is the measured-fidelity model.  The
    resolved :attr:`tech` is what every delegate below evaluates with --
    callers that used to import ``DEFAULT_TECH`` directly now construct
    (or receive) a ``CostModel`` and never touch module constants.
    """

    def __init__(
        self,
        tech: TechConstants | None = None,
        corrections: CorrectionFactors | None = None,
    ):
        self.base = resolve_tech(tech)
        self.corrections = corrections
        #: the effective constants (corrections applied; ``is`` the base
        #: object when uncalibrated, so analytic identity is bit-exact)
        self.tech = self.base.with_corrections(corrections)

    @property
    def calibrated(self) -> bool:
        """True when corrections actually change the constants."""
        return self.tech is not self.base

    @property
    def version(self) -> str:
        """Content version of the applied corrections
        (``"uncalibrated"`` for the analytic model)."""
        return calibration_version(self.corrections)

    def __repr__(self) -> str:
        return f"CostModel(version={self.version!r})"

    # -- delegates (lazy imports: cost_model/template import THIS module) --
    def macro_params(self, macro):
        """Traceable macro params under this model's constants."""
        from repro_torch.core import cost_model as _cm

        return _cm.macro_params(macro, self.tech)

    def tech_params(self):
        """Traceable tech params under this model's constants."""
        from repro_torch.core import cost_model as _cm

        return _cm.tech_params(self.tech)

    def workload_metrics(self, ops_arr, cfg_row, macro, objective="ee",
                         strategy_set: str = "st") -> dict:
        """Human-facing PPA metrics (see ``cost_model.workload_metrics``)."""
        from repro_torch.core import cost_model as _cm

        return _cm.workload_metrics(ops_arr, cfg_row, macro, self.tech,
                                    objective, strategy_set)

    def accelerator_area_mm2(self, cfg, macro) -> float:
        """Template area under this model's constants (area is correction-
        invariant by construction, but routed here for API symmetry)."""
        from repro_torch.core.template import accelerator_area_mm2 as _area

        return _area(cfg, macro, self.tech)

    def peak_tops(self, cfg, macro) -> float:
        """Peak throughput of a configured grid under this model."""
        from repro_torch.core.template import peak_tops as _peak

        return _peak(cfg, macro, self.tech)


_default_cost_model: CostModel | None = None
_dcm_lock = threading.Lock()


def default_cost_model() -> CostModel:
    """The process-wide :class:`CostModel`: calibrated from the pinned
    :data:`CALIBRATION_ENV` artifact when set, analytic otherwise.
    Cached; :func:`reset_default_cost_model` (or
    :func:`reset_calibration_state`) re-resolves after env changes."""
    global _default_cost_model
    with _dcm_lock:
        if _default_cost_model is None:
            pinned = _pinned_artifact()
            _default_cost_model = CostModel(
                corrections=pinned[0] if pinned is not None else None)
        return _default_cost_model


def reset_default_cost_model() -> None:
    """Drop the cached process-wide :class:`CostModel` (tests / env
    re-pointing)."""
    global _default_cost_model
    with _dcm_lock:
        _default_cost_model = None
