"""Tkinter desktop app: the four ExTrack analyses with a point-and-click UI.

Functional equivalent of the reference's stand-alone GUI (ExTrack_GUI.py)
and of the JAX package's (``extrack_tpu/gui.py``), on the port's drivers:
a main window configures the input file, track lengths, column names,
localization-error handling and the device, then opens one of four
analysis windows — Model Fitting, State Labeling, State Lifetime
Histogram, Position Refinement (ExTrack_GUI.py:1288-1293).  On the card
(``Session.device``, default the card) every analysis runs the CUDA
kernels (K2 and K3 for the fit, K4, K5, K6); the Model Fitting window's
seeded frame_len 6 runs K2 and K3 on their wide mapping from 4 states on
(4^6 = 4096 slots; 5^6 = 15,625 at 5 states and 6^6 = 46,656 at 6, with
their exchange in global scratch; frame_len 8 at 4 states, 65,536 slots,
too), and a choice past a kernel's envelope (frame_len 7 at 5 states
passes K2's 65536 slots, frame_len 10 at 3 states its 16384 fusion
groups) raises as ``fit.param_fitting`` does, naming the kernel.  The
State Lifetime Histogram's window 8 runs K5 past 16384 slots from 4
states on (4^8 = 65,536; 5^8 = 390,625 of its 2^19), harvesting from
each slot's digits.

Design: every analysis is a plain function over a ``Session`` dataclass
(testable without a display); the Tk layer is a thin shell that fills the
dataclass from widgets and imports ``tkinter`` only when a window opens.
Launch with ``python -m extrack_tpu_torch.gui`` or
``extrack-tpu-torch-gui``.
"""
from __future__ import annotations

import dataclasses
import json
import threading
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class Session:
    """Everything the GUI windows configure (ExTrack_GUI.py:1203-1212)."""
    path: str = ""
    dt: float = 0.02
    min_len: int = 5
    max_len: int = 40
    dist_th: float = np.inf
    x_col: str = "POSITION_X"
    y_col: str = "POSITION_Y"
    frame_col: str = "FRAME"
    id_col: str = "TRACK_ID"
    quality_col: str = ""          # maps to LocErr = 1/sqrt(q), GUI :273-278
    nb_states: int = 2
    cell_dims: tuple = (1.0,)
    frame_len_fit: int = 6         # GUI default frame_len 6 for fitting
    frame_len_label: int = 10      # and 10 for labeling (ExTrack_GUI.py:1207)
    nb_iters: int = 3              # GUI default 3 fit iterations
    params_values: Optional[Dict[str, float]] = None
    params_spec: Optional[object] = None   # full Parameters (editor result)
    output_dir: str = "."
    device: Optional[str] = None   # None: the card (raises without one)

    # loaded data
    tracks: Optional[dict] = None
    frames: Optional[dict] = None
    input_loc_err: Optional[dict] = None

    def load(self):
        from extrack_tpu_torch.io import readers
        lengths = np.arange(self.min_len, self.max_len + 1)
        opt = [self.quality_col] if self.quality_col else []
        if self.path.endswith(".xml"):
            tracks, frames, om = readers.read_trackmate_xml(
                self.path, lengths=lengths, dist_th=self.dist_th,
                opt_metrics_names=opt)
        else:
            tracks, frames, om = readers.read_table(
                self.path, lengths=lengths, dist_th=self.dist_th,
                colnames=[self.x_col, self.y_col, self.frame_col,
                          self.id_col],
                opt_colnames=opt)
        self.tracks, self.frames = tracks, frames
        if self.quality_col:
            q = om[self.quality_col]
            self.input_loc_err = {
                k: 1.0 / np.sqrt(np.maximum(q[k].astype(np.float64), 1e-12))
                for k in q}
        else:
            # clear any per-peak errors from a previous load: a stale dict
            # keyed for the old file would crash (or silently re-apply
            # quality errors the user turned off)
            self.input_loc_err = None
        return sum(v.shape[0] for v in tracks.values())

    def spec(self):
        from extrack_tpu_torch import params as tparams
        if self.params_spec is not None:
            return self.params_spec.copy()
        if self.params_values:
            spec = tparams.Parameters()
            for k, v in self.params_values.items():
                spec.add(k, float(v), vary=False)
            return spec
        return tparams.generate_params(
            nb_states=self.nb_states,
            LocErr_type=None if self.input_loc_err is not None else 1,
            D_max=3.0)


# ---------------------------------------------------------------------------
# parameter editor logic (display-free; the Tk ParameterWindow is a shell)
# ---------------------------------------------------------------------------

def spec_rows(spec):
    """Editor rows for a Parameters spec: (name, value, min, max, vary,
    expr).  Rows with an expr are derived quantities (read-only vary).
    Equivalent surface to the reference ParameterWindow
    (ExTrack_GUI.py:1096-1189) plus per-parameter min/max/vary."""
    return [(name, p.value, p.min, p.max, p.vary, p.expr)
            for name, p in spec.items()]


def apply_rows(spec, rows):
    """Apply edited (name, value, min, max, vary) rows onto a copy of
    ``spec``.  Expression-constrained parameters keep their expr (their
    value is derived; vary edits are ignored, as in lmfit)."""
    out = spec.copy()
    for row in rows:
        name, value, mn, mx, vary = row[:5]
        if name not in out:
            continue
        p = out[name]
        p.value = float(value)
        p.min = float(mn)
        p.max = float(mx)
        if p.expr is None:
            p.vary = bool(vary)
    return out


# ---------------------------------------------------------------------------
# per-analysis option schemas (display-free; each Tk analysis window is a
# shell over one schema, mirroring the reference's four dedicated windows:
# create_fitting_window :103, predictions :495, lifetime :708, refinement
# :895 in ExTrack_GUI.py)
# ---------------------------------------------------------------------------

ANALYSIS_OPTIONS = {
    "Model Fitting": [
        # (key, type, default, label)
        ("nb_iters", int, 3, "fit iterations"),
        ("frame_len", int, 6, "frame_len (fusion window)"),
        ("nb_substeps", int, 1, "sub-steps per frame"),
        ("steady_state", bool, False, "steady-state fractions"),
        # the reference GUI runs powell on the first iteration because its
        # finite-difference BFGS is fragile (ExTrack_GUI.py:298); with exact
        # gradients L-BFGS-B is the better default, powell stays available
        ("first_method", str, "L-BFGS-B",
         "first-iteration method (L-BFGS-B/powell)"),
        ("compute_errors", bool, True, "Fisher standard errors"),
    ],
    "State Labeling": [
        ("frame_len", int, 10, "frame_len (labeling window)"),
    ],
    "State Lifetime Histogram": [
        ("frame_len", int, 8, "frame_len (histogram window)"),
        ("long_tracks", bool, False, "keep only long tracks"),
        ("min_len_hist", int, 10, "min track length if long-only"),
    ],
    "Position Refinement": [
        ("frame_len", int, 7, "frame_len (refinement window)"),
    ],
}


def default_options(analysis: str) -> dict:
    return {k: d for k, _, d, _ in ANALYSIS_OPTIONS[analysis]}


def seeded_options(analysis: str, s: Session) -> dict:
    """Schema defaults overridden by the main window's session fields, so
    the 'frame_len (fit)' / 'fit iterations' / 'frame_len (labeling)'
    entries the user typed actually seed the analysis window (they used to
    be dead: the window's static defaults always won)."""
    o = default_options(analysis)
    if analysis == "Model Fitting":
        o["nb_iters"] = s.nb_iters
        o["frame_len"] = s.frame_len_fit
    elif analysis == "State Labeling":
        o["frame_len"] = s.frame_len_label
    elif analysis == "Position Refinement":
        # per-state-count schedule (refine.default_window, the JAX
        # package's): the static 2-state default 7 is a register of
        # S**7 slots, past K6's 16384 from 5 states on.  Resolved at the
        # session's real track length (loaded tracks, else the loader's
        # max-len filter), as the schedule depends on it
        from extrack_tpu_torch import refine
        T = (max(int(k) for k in s.tracks) if s.tracks
             else int(s.max_len))
        o["frame_len"] = refine.default_window(s.nb_states, T=T)
    return o


def parse_options(analysis: str, raw: Dict[str, str]) -> dict:
    """Parse the string fields of an analysis window into typed options."""
    out = {}
    for key, typ, default, _ in ANALYSIS_OPTIONS[analysis]:
        v = raw.get(key, default)
        if typ is bool and isinstance(v, str):
            v = v.strip().lower() in ("1", "true", "yes", "on")
        out[key] = typ(v)
    return out


# ---------------------------------------------------------------------------
# analysis runners (display-free; the Tk shell calls these in a thread)
# ---------------------------------------------------------------------------

def run_fitting(s: Session, progress=print, options: Optional[dict] = None):
    """Iterated fit like the GUI (nb_iters rounds, powell first iteration
    then gradient iterations, ExTrack_GUI.py:289-321); with exact gradients
    one L-BFGS run usually converges, extra iterations simply restart from
    the optimum.  Starts from the parameter-editor spec when configured."""
    from extrack_tpu_torch import fit
    o = {**seeded_options("Model Fitting", s), **(options or {})}
    if s.params_spec is not None:
        params = s.params_spec.copy()
    elif s.params_values:
        # a loaded params JSON warm-starts the fit (values only; bounds and
        # vary flags stay at their generate_params defaults)
        from extrack_tpu_torch import params as tparams
        params = tparams.generate_params(
            nb_states=s.nb_states,
            LocErr_type=None if s.input_loc_err is not None else 1,
            D_max=3.0)
        vals = dict(s.params_values)
        # D1.. are expr-tied to cumulative diffs: invert them first
        # (missing D's default to the spec's current resolved values)
        resolved = params.resolve()
        targets = [float(vals.get(f"D{i}", resolved.get(f"D{i}", 0.0)))
                   for i in range(s.nb_states)]
        for i in range(1, s.nb_states):
            diff = f"D{i}_minus_D{i - 1}"
            if diff in params and f"D{i}" in vals:
                params[diff].value = max(targets[i] - targets[i - 1], 1e-12)
        for k, v in vals.items():
            if k in params and params[k].expr is None:
                params[k].value = float(v)
    else:
        params = None
    res = None
    for it in range(max(1, int(o["nb_iters"]))):
        method = o["first_method"] if it == 0 else "L-BFGS-B"
        last = it == max(1, int(o["nb_iters"])) - 1
        res = fit.param_fitting(
            s.tracks, s.dt, params=params, nb_states=s.nb_states,
            frame_len=int(o["frame_len"]), cell_dims=s.cell_dims,
            nb_substeps=int(o["nb_substeps"]),
            steady_state=bool(o["steady_state"]), method=method,
            input_LocErr=s.input_loc_err, verbose=0,
            compute_errors=bool(o["compute_errors"]) and last,
            device=s.device)
        params = res.params
        progress(f"iteration {it + 1}: logL = {res.logl:.3f}")
    s.params_values = res.params.valuesdict()
    # subsequent analyses (and a re-opened editor) must see the FITTED
    # optimum — spec() prefers params_spec, which used to keep pre-fit
    # editor values and silently ignore the fit
    s.params_spec = res.params.copy()
    out = f"{s.output_dir}/extrack_fitted_params.json"
    with open(out, "w") as fh:
        json.dump({"values": s.params_values,
                   "std_errors": res.std_errors, "logL": res.logl}, fh,
                  indent=1)
    progress(f"saved {out}")
    return res


def run_predictions(s: Session, progress=print,
                    options: Optional[dict] = None):
    """State labeling (ExTrack_GUI.py:495-586) -> annotated CSV."""
    from extrack_tpu_torch import predict
    from extrack_tpu_torch.io import exporters
    o = {**seeded_options("State Labeling", s), **(options or {})}
    preds = predict.predict_Bs(
        s.tracks, s.dt, s.spec(), cell_dims=s.cell_dims,
        nb_states=s.nb_states, frame_len=int(o["frame_len"]),
        input_LocErr=s.input_loc_err, device=s.device)
    out = f"{s.output_dir}/extrack_predictions.csv"
    exporters.save_extrack_2_CSV(out, s.tracks, preds, s.dt,
                                 all_frames=s.frames)
    progress(f"saved {out}")
    return preds


def run_lifetime(s: Session, progress=print,
                 options: Optional[dict] = None):
    """State lifetime histogram (ExTrack_GUI.py:708-767) -> CSV + PNG.

    The histogram is ``histograms.len_hist`` on the session's device (with
    "keep only long tracks", the tracks of at least ``min_len_hist``
    frames, all of them where none is that long), as
    ``visualization.visualize_states_durations`` computes it; the PNG is
    its plot, written where matplotlib is installed."""
    import importlib.util
    from extrack_tpu_torch import histograms
    o = {**default_options("State Lifetime Histogram"), **(options or {})}
    tracks = s.tracks
    if bool(o["long_tracks"]):
        tracks = {k: v for k, v in tracks.items()
                  if int(k) >= int(o["min_len_hist"])} or tracks
    hists = histograms.len_hist(
        tracks, s.spec(), s.dt, cell_dims=s.cell_dims,
        nb_states=s.nb_states, input_LocErr=s.input_loc_err,
        max_nb_states=2 ** min(int(o["frame_len"]), 8),
        window=int(o["frame_len"]), device=s.device)
    out = f"{s.output_dir}/extrack_durations"
    np.savetxt(out + ".csv", hists, delimiter=",")
    if importlib.util.find_spec("matplotlib") is None:
        progress(f"saved {out}.csv (matplotlib is not installed: no plot)")
        return hists
    from extrack_tpu_torch import visualization as viz
    import matplotlib.pyplot as plt
    viz.visualize_states_durations(
        tracks, s.spec(), s.dt, nb_states=s.nb_states, hists=hists,
        nb_steps_lim=int(o["min_len_hist"]))
    plt.savefig(out + ".png", dpi=150)
    progress(f"saved {out}.csv / .png")
    return hists


def run_refinement(s: Session, progress=print,
                   options: Optional[dict] = None):
    """Position refinement (ExTrack_GUI.py:895-978) -> CSV."""
    from extrack_tpu_torch import refine
    from extrack_tpu_torch.io import exporters
    o = {**default_options("Position Refinement"), **(options or {})}
    loc_err, ds, Fs, tr = refine.refinement_args(s.spec(), s.nb_states,
                                                 s.dt)
    mus, sigmas = refine.position_refinement(
        s.tracks,
        s.input_loc_err if s.input_loc_err is not None else loc_err,
        ds, Fs, tr, frame_len=min(int(o["frame_len"]), 8), device=s.device)
    out = f"{s.output_dir}/extrack_refined.csv"
    exporters.refined_2_pandas(s.tracks, mus, sigmas).to_csv(out,
                                                             index=False)
    progress(f"saved {out}")
    return mus, sigmas


_ANALYSES = {
    "Model Fitting": run_fitting,
    "State Labeling": run_predictions,
    "State Lifetime Histogram": run_lifetime,
    "Position Refinement": run_refinement,
}

# serialize compute across analysis windows (one job on the card at a time)
_COMPUTE_LOCK = threading.Lock()


# ---------------------------------------------------------------------------
# Tk shell
# ---------------------------------------------------------------------------

class ParameterWindow:
    """Per-parameter editor: value / min / max / vary for every model
    parameter, with derived (expr) parameters shown read-only.

    Equivalent of the reference ParameterWindow (ExTrack_GUI.py:1096-1189),
    which edits values only; bounds and vary flags are first-class here
    because the fit honors them (sigmoid bound bijections).  On OK the
    edited spec is stored on the session and used by every analysis and as
    the warm start for fitting iterations (ExTrack_GUI.py:305-320).
    """

    def __init__(self, master, session: Session, on_close=None):
        import tkinter as tk
        from tkinter import ttk
        self.session = session
        self.on_close = on_close
        self.window = tk.Toplevel(master)
        self.window.title("Parameters")
        spec = session.spec()
        self._spec = spec
        self._rows = []
        for c, head in enumerate(("parameter", "value", "min", "max",
                                  "vary", "expr")):
            ttk.Label(self.window, text=head).grid(row=0, column=c,
                                                   padx=4, pady=2)
        for r, (name, value, mn, mx, vary, expr) in enumerate(
                spec_rows(spec), start=1):
            ttk.Label(self.window, text=name).grid(row=r, column=0,
                                                   sticky="w", padx=4)
            svars = []
            for c, val in enumerate((value, mn, mx)):
                var = tk.StringVar(value=f"{val:.6g}")
                ttk.Entry(self.window, textvariable=var, width=10).grid(
                    row=r, column=1 + c, padx=2)
                svars.append(var)
            vvar = tk.BooleanVar(value=bool(vary))
            chk = ttk.Checkbutton(self.window, variable=vvar)
            chk.grid(row=r, column=4)
            if expr is not None:
                chk.state(["disabled"])
                ttk.Label(self.window, text=expr).grid(row=r, column=5,
                                                       sticky="w", padx=4)
            self._rows.append((name, svars, vvar))
        ttk.Button(self.window, text="OK", command=self.ok_clicked).grid(
            row=len(self._rows) + 1, column=0, columnspan=6, pady=8)

    def edited_rows(self):
        return [(name, float(svars[0].get()), float(svars[1].get()),
                 float(svars[2].get()), bool(vvar.get()))
                for name, svars, vvar in self._rows]

    def ok_clicked(self):
        self.session.params_spec = apply_rows(self._spec,
                                              self.edited_rows())
        if self.on_close:
            self.on_close()
        self.window.destroy()


class AnalysisWindow:
    """Dedicated per-analysis options window (reference opens one window
    per analysis type: ExTrack_GUI.py:34-70 open_analysis_window ->
    create_fitting_window :103 / predictions :495 / lifetime :708 /
    refinement :895).  Fields come from ANALYSIS_OPTIONS[analysis]; Run
    executes the analysis in a worker thread with the parsed options."""

    def __init__(self, master, session: Session, analysis: str, progress):
        import queue
        import tkinter as tk
        from tkinter import ttk
        self.session = session
        self.analysis = analysis
        self.progress = progress
        self.window = tk.Toplevel(master)
        self.window.title(analysis)
        self._vars = {}
        self._msgq: "queue.Queue[str]" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        seeds = seeded_options(analysis, session)
        for r, (key, typ, default, label) in enumerate(
                ANALYSIS_OPTIONS[analysis]):
            ttk.Label(self.window, text=label).grid(row=r, column=0,
                                                    sticky="w", padx=4,
                                                    pady=2)
            if typ is bool:
                var = tk.BooleanVar(value=bool(seeds[key]))
                ttk.Checkbutton(self.window, variable=var).grid(row=r,
                                                                column=1)
            else:
                var = tk.StringVar(value=str(seeds[key]))
                ttk.Entry(self.window, textvariable=var, width=12).grid(
                    row=r, column=1, padx=4)
            self._vars[key] = var
        row = len(ANALYSIS_OPTIONS[analysis])
        ttk.Button(self.window, text="Edit parameters...",
                   command=self.edit_params).grid(row=row, column=0, pady=8)
        self.run_btn = ttk.Button(self.window, text="Run",
                                  command=self.run_clicked)
        self.run_btn.grid(row=row, column=1, pady=8)
        self._poll()

    def options(self):
        return parse_options(self.analysis,
                             {k: v.get() for k, v in self._vars.items()})

    def edit_params(self):
        ParameterWindow(self.window, self.session,
                        on_close=lambda: self.progress("parameters updated"))

    def _poll(self):
        """Drain worker messages on the Tk main thread (Tkinter widgets are
        not thread-safe: the worker must never touch them directly).  Every
        step is guarded: one progress/widget exception (e.g. the log pane's
        window was closed) must not kill the poll loop and leave the Run
        button disabled forever."""
        import queue
        try:
            while True:
                msg = self._msgq.get_nowait()
                try:
                    self.progress(msg)
                except Exception:
                    pass                       # log widget gone
        except queue.Empty:
            pass
        try:
            if self._worker is not None and not self._worker.is_alive():
                self._worker = None
                self.run_btn.state(["!disabled"])
        except Exception:
            pass
        try:
            self.window.after(150, self._poll)
        except Exception:
            pass                               # window destroyed

    def run_clicked(self):
        if self._worker is not None and self._worker.is_alive():
            self.progress("a computation is already running")
            return
        opts = self.options()
        fn = _ANALYSES[self.analysis]
        self.progress(f"{self.analysis}: {opts}")
        self.run_btn.state(["disabled"])
        post = self._msgq.put

        def work():
            # one computation at a time, across ALL windows: the card
            # runs one analysis, and the session's state is shared
            with _COMPUTE_LOCK:
                try:
                    fn(self.session, post, options=opts)
                except Exception as exc:
                    post(f"ERROR: {exc!r}")

        self._worker = threading.Thread(target=work, daemon=True)
        self._worker.start()


def launch():
    import tkinter as tk
    from tkinter import filedialog, scrolledtext, ttk

    session = Session()
    root = tk.Tk()
    root.title("extrack-tpu-torch")

    frm = ttk.Frame(root, padding=10)
    frm.grid(sticky="nsew")
    entries = {}

    def add_row(r, label, default):
        ttk.Label(frm, text=label).grid(row=r, column=0, sticky="w")
        var = tk.StringVar(value=str(default))
        ttk.Entry(frm, textvariable=var, width=32).grid(row=r, column=1)
        entries[label] = var
        return r + 1

    r = 0
    ttk.Label(frm, text="Input file (CSV / TrackMate XML)").grid(
        row=r, column=0, sticky="w")
    path_var = tk.StringVar()
    ttk.Entry(frm, textvariable=path_var, width=32).grid(row=r, column=1)

    def browse():
        p = filedialog.askopenfilename()
        if p:
            path_var.set(p)
    ttk.Button(frm, text="...", command=browse).grid(row=r, column=2)
    r += 1
    r = add_row(r, "dt (s)", session.dt)
    r = add_row(r, "min length", session.min_len)
    r = add_row(r, "max length", session.max_len)
    r = add_row(r, "x column", session.x_col)
    r = add_row(r, "y column", session.y_col)
    r = add_row(r, "frame column", session.frame_col)
    r = add_row(r, "track id column", session.id_col)
    r = add_row(r, "quality column (optional)", "")
    r = add_row(r, "number of states", session.nb_states)
    r = add_row(r, "cell dims (um, comma sep.)", "1.0")
    r = add_row(r, "frame_len (fit)", session.frame_len_fit)
    r = add_row(r, "frame_len (labeling)", session.frame_len_label)
    r = add_row(r, "fit iterations", session.nb_iters)
    r = add_row(r, "params JSON (optional)", "")
    r = add_row(r, "output directory", ".")
    r = add_row(r, "device (cuda / cpu)", "cuda")

    analysis_var = tk.StringVar(value="Model Fitting")
    ttk.Label(frm, text="Analysis").grid(row=r, column=0, sticky="w")
    ttk.Combobox(frm, textvariable=analysis_var,
                 values=list(_ANALYSES)).grid(row=r, column=1)
    r += 1

    log = scrolledtext.ScrolledText(frm, width=60, height=12)
    log.grid(row=r + 1, column=0, columnspan=3)

    def progress(msg):
        log.insert("end", str(msg) + "\n")
        log.see("end")

    def fill_session():
        session.path = path_var.get()
        session.dt = float(entries["dt (s)"].get())
        session.min_len = int(entries["min length"].get())
        session.max_len = int(entries["max length"].get())
        session.x_col = entries["x column"].get()
        session.y_col = entries["y column"].get()
        session.frame_col = entries["frame column"].get()
        session.id_col = entries["track id column"].get()
        session.quality_col = entries["quality column (optional)"].get()
        session.nb_states = int(entries["number of states"].get())
        session.cell_dims = tuple(
            float(c) for c in
            entries["cell dims (um, comma sep.)"].get().split(","))
        session.frame_len_fit = int(entries["frame_len (fit)"].get())
        session.frame_len_label = int(entries["frame_len (labeling)"].get())
        session.nb_iters = int(entries["fit iterations"].get())
        session.output_dir = entries["output directory"].get() or "."
        session.device = entries["device (cuda / cpu)"].get() or None
        pj = entries["params JSON (optional)"].get()
        if pj:
            with open(pj) as fh:
                payload = json.load(fh)
            session.params_values = payload.get("values", payload)

    def run():
        """Open the dedicated analysis window (the reference's
        open_analysis_window flow, ExTrack_GUI.py:34-70)."""
        try:
            fill_session()
            n = session.load()
            progress(f"loaded {n} tracks")
            AnalysisWindow(root, session, analysis_var.get(), progress)
        except Exception as exc:          # surface errors in the log pane
            progress(f"ERROR: {exc!r}")

    def edit_params():
        try:
            fill_session()
            ParameterWindow(root, session,
                            on_close=lambda: progress("parameters updated"))
        except Exception as exc:
            progress(f"ERROR: {exc!r}")

    ttk.Button(frm, text="Edit parameters...",
               command=edit_params).grid(row=r, column=0)
    ttk.Button(frm, text="Open analysis...", command=run).grid(row=r,
                                                               column=1)
    root.mainloop()


def main():
    launch()


if __name__ == "__main__":
    main()
