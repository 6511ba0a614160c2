"""Local analysis web UI — run history, artifact viewers, job management.

Reference: JanusX python/janusx/ui/server.py (stdlib
ThreadingHTTPServer :30, job state + history DB :439, GWAS column
sniffing :353) — a zero-dependency local dashboard over the SQLite run
registry (janusx_tpu.utils.history) with:

  /            dashboard: job table + run history + submit form
  /run/<id>    recorded run detail (params, outputs, previews)
  /run/<id>/render (POST)  render Manhattan+QQ for the run's assoc TSVs
                           in the browser (reference /api/gwas-history/
                           <id>/render)
  /run/<id>/sigsites?thr=  significant-site table for the run's assoc
                           TSVs (reference .../sigsites)
  /upload      (POST form: name + pasted TSV content) drop an arbitrary
               assoc TSV: renders Manhattan+QQ + sigsites (reference
               /api/gwas-upload)
  /job/<id>    live job detail (status, log tail)
  /job/<id>/cancel (POST)
  /submit      (POST) launch `jx <module> ...` as a tracked subprocess
  /file?p=...  artifact server (restricted to registered output roots)
  /api/runs, /api/jobs  JSON

Jobs run `python -m janusx_tpu.cli.main <module> <args>` detached with a
per-job log; completed CLI runs self-register in the history DB, so a
finished job also appears in the history table.
"""

from __future__ import annotations

import html
import json
import os
import shlex
import signal
import subprocess
import sys
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from janusx_tpu_torch.utils import history

ALLOWED_MODULES = (
    "gwas", "gs", "grm", "pca", "gstats", "sim", "tree", "garfield",
    "postgwas", "postgs", "fastpop", "gformat", "reml", "bsa",
)

_STYLE = """
body{font-family:system-ui,sans-serif;margin:1.5em;max-width:1100px}
table{border-collapse:collapse;width:100%}
td,th{padding:4px 10px;border-bottom:1px solid #e2e2e2;text-align:left;
      font-size:14px}
th{background:#f6f6f6}
a{color:#2b6cb0;text-decoration:none} a:hover{text-decoration:underline}
.status-ok{color:#15803d}.status-failed{color:#b91c1c}
.status-running{color:#b45309}
pre{background:#f8f8f8;padding:10px;overflow-x:auto;font-size:12px}
input,select{padding:4px;font-size:14px}
.card{border:1px solid #e2e2e2;border-radius:6px;padding:12px;margin:12px 0}
img{max-width:100%}
"""


class Job:
    _next_id = 1
    _lock = threading.Lock()

    def __init__(self, module: str, args: list, workdir: str):
        with Job._lock:
            self.id = Job._next_id
            Job._next_id += 1
        self.module = module
        self.args = args
        self.workdir = workdir
        self.log_path = os.path.join(workdir, f"job{self.id}.{module}.joblog")
        self.started = time.time()
        self.finished: float | None = None
        self.returncode: int | None = None
        cmd = [sys.executable, "-m", "janusx_tpu_torch.cli.main", module] + args
        # the package may be imported from a source tree rather than
        # site-packages — make sure the child can import it from anywhere
        env = dict(os.environ)
        import janusx_tpu_torch

        pkg_root = os.path.dirname(os.path.dirname(
            os.path.abspath(janusx_tpu_torch.__file__)))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        self._logf = open(self.log_path, "wb")
        self.proc = subprocess.Popen(
            cmd, cwd=workdir, stdout=self._logf, stderr=subprocess.STDOUT,
            start_new_session=True, env=env,
        )
        threading.Thread(target=self._wait, daemon=True).start()

    def _wait(self):
        self.returncode = self.proc.wait()
        self.finished = time.time()
        self._logf.close()

    @property
    def status(self) -> str:
        if self.returncode is None:
            return "running"
        return "ok" if self.returncode == 0 else "failed"

    def cancel(self):
        if self.returncode is None:
            try:
                os.killpg(self.proc.pid, signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                pass

    def log_tail(self, n: int = 200) -> str:
        try:
            with open(self.log_path, "rb") as fh:
                fh.seek(0, 2)
                size = fh.tell()
                fh.seek(max(0, size - 65536))
                lines = fh.read().decode(errors="replace").splitlines()
            return "\n".join(lines[-n:])
        except OSError:
            return ""


class UiState:
    def __init__(self, workdir: str):
        self.workdir = os.path.abspath(workdir)
        self.jobs: dict[int, Job] = {}
        self.roots = {self.workdir}
        # per-server CSRF token: form POSTs from other origins (a hostile
        # web page hitting 127.0.0.1) cannot read it, so they cannot
        # launch jobs or cancel them
        import secrets

        self.csrf = secrets.token_hex(16)
        self._roots_cache: tuple[float, set] | None = None
        self._roots_lock = threading.Lock()

    def submit(self, module: str, argline: str) -> Job:
        if module not in ALLOWED_MODULES:
            raise ValueError(f"module not allowed: {module}")
        args = shlex.split(argline)
        job = Job(module, args, self.workdir)
        self.jobs[job.id] = job
        return job

    def _run_roots(self) -> set:
        """Output roots of ALL recorded runs (cached briefly — a locus page
        with a dozen images must not rescan the DB per request)."""
        now = time.time()
        with self._roots_lock:
            if self._roots_cache and now - self._roots_cache[0] < 5.0:
                return self._roots_cache[1]
        roots = set(self.roots)
        for prefix in history.list_run_prefixes():
            roots.add(os.path.realpath(os.path.dirname(os.path.abspath(prefix))))
        with self._roots_lock:
            self._roots_cache = (now, roots)
        return roots

    def allowed_file(self, path: str) -> bool:
        real = os.path.realpath(path)
        roots = self._run_roots()
        return any(real == r or real.startswith(r + os.sep) for r in roots)


def _page(title: str, body: str) -> bytes:
    return (
        f"<html><head><title>{html.escape(title)}</title>"
        f"<style>{_STYLE}</style></head><body>"
        f"<p><a href='/'>&larr; dashboard</a></p><h2>{html.escape(title)}</h2>"
        f"{body}</body></html>"
    ).encode()


def _fmt_ts(ts: float) -> str:
    return time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(ts))


def _preview(path: str) -> str:
    if path.endswith((".png", ".jpg", ".svg")):
        return f"<img src='/file?p={urllib.parse.quote(path)}'>"
    if path.endswith(".json"):
        try:
            data = json.load(open(path))
            return f"<pre>{html.escape(json.dumps(data, indent=2)[:20000])}</pre>"
        except (OSError, ValueError):
            return "<i>unreadable</i>"
    if path.endswith((".tsv", ".txt", ".log", ".nwk", ".joblog")):
        try:
            with open(path, "rt", errors="replace") as fh:
                lines = [next(fh, "") for _ in range(50)]
        except OSError:
            return "<i>unreadable</i>"
        if path.endswith(".tsv") and lines and "\t" in lines[0]:
            rows = [
                "<tr>" + "".join(
                    f"<td>{html.escape(c)}</td>" for c in ln.rstrip().split("\t")
                ) + "</tr>"
                for ln in lines if ln.strip()
            ]
            return "<table>" + "".join(rows) + "</table>"
        return f"<pre>{html.escape(''.join(lines))}</pre>"
    return ""


class Handler(BaseHTTPRequestHandler):
    state: UiState = None  # injected

    def log_message(self, fmt, *args):
        pass

    def _send(self, body: bytes, ctype="text/html; charset=utf-8", code=200):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj):
        self._send(json.dumps(obj, default=str).encode(), "application/json")

    def do_GET(self):
        url = urllib.parse.urlparse(self.path)
        q = urllib.parse.parse_qs(url.query)
        route = url.path
        if route == "/":
            return self._send(self._dashboard())
        if route == "/api/runs":
            return self._json(history.list_runs_full(100))
        if route == "/api/jobs":
            return self._json([
                {"id": j.id, "module": j.module, "status": j.status,
                 "started": j.started, "args": j.args}
                for j in self.state.jobs.values()
            ])
        if route.startswith("/run/") and route.endswith("/sigsites"):
            try:
                run_id = int(route.split("/")[2])
            except (ValueError, IndexError):
                return self._send(_page("not found", ""), code=404)
            thr = q.get("thr", [None])[0]
            try:
                thr_f = None if thr is None else float(thr)
            except ValueError:
                return self._send(_page("bad request",
                                        "thr must be a number"), code=400)
            return self._sigsites(run_id, thr_f)
        if route.startswith("/run/"):
            try:
                run_id = int(route.split("/")[2])
            except (ValueError, IndexError):
                return self._send(_page("not found", ""), code=404)
            return self._run_detail(run_id)
        if route.startswith("/job/"):
            try:
                job_id = int(route.split("/")[2])
            except (ValueError, IndexError):
                return self._send(_page("not found", ""), code=404)
            return self._job_detail(job_id)
        if route == "/file":
            return self._file(q.get("p", [""])[0])
        self._send(_page("not found", ""), code=404)

    def do_POST(self):
        url = urllib.parse.urlparse(self.path)
        length = int(self.headers.get("Content-Length", 0))
        form = urllib.parse.parse_qs(self.rfile.read(length).decode())
        # all POSTs are state-changing: require the per-server CSRF token
        # (cross-origin form POSTs to 127.0.0.1 cannot read it)
        if form.get("csrf", [""])[0] != self.state.csrf:
            return self._send(_page("forbidden", "bad csrf token"), code=403)
        if url.path == "/submit":
            module = form.get("module", [""])[0]
            argline = form.get("args", [""])[0]
            try:
                job = self.state.submit(module, argline)
            except ValueError as e:
                return self._send(_page("error", html.escape(str(e))), code=400)
            self.send_response(303)
            self.send_header("Location", f"/job/{job.id}")
            self.end_headers()
            return
        m = url.path.split("/")
        if len(m) == 4 and m[1] == "run" and m[3] == "render":
            try:
                run_id = int(m[2])
            except ValueError:
                return self._send(_page("not found", ""), code=404)
            return self._render_run(run_id)
        if url.path == "/upload":
            return self._upload(form)
        if len(m) == 4 and m[1] == "job" and m[3] == "cancel":
            try:
                job = self.state.jobs.get(int(m[2]))
            except ValueError:
                job = None
            if job:
                job.cancel()
            self.send_response(303)
            self.send_header("Location", f"/job/{m[2]}")
            self.end_headers()
            return
        self._send(_page("not found", ""), code=404)

    def _dashboard(self) -> bytes:
        jobs_rows = "".join(
            f"<tr><td><a href='/job/{j.id}'>#{j.id}</a></td>"
            f"<td>{j.module}</td>"
            f"<td class='status-{j.status}'>{j.status}</td>"
            f"<td>{_fmt_ts(j.started)}</td>"
            f"<td>{html.escape(' '.join(j.args))[:80]}</td></tr>"
            for j in sorted(self.state.jobs.values(), key=lambda j: -j.id)
        ) or "<tr><td colspan=5><i>no jobs this session</i></td></tr>"
        hist_rows = "".join(
            f"<tr><td><a href='/run/{r[0]}'>#{r[0]}</a></td>"
            f"<td>{_fmt_ts(r[1])}</td><td>{html.escape(r[2])}</td>"
            f"<td>{html.escape(str(r[3] or ''))}</td>"
            f"<td>{'' if r[6] is None else f'{r[6]:.1f}s'}</td>"
            f"<td class='status-{r[7]}'>{html.escape(str(r[7]))}</td></tr>"
            for r in history.list_runs_full(50)
        ) or "<tr><td colspan=6><i>no recorded runs</i></td></tr>"
        opts = "".join(f"<option>{m}</option>" for m in ALLOWED_MODULES)
        body = (
            "<div class='card'><h3>Submit a job</h3>"
            "<form method='post' action='/submit'>"
            f"<input type='hidden' name='csrf' value='{self.state.csrf}'>"
            f"<select name='module'>{opts}</select> "
            "<input name='args' size='80' placeholder='-bfile data -p p.tsv "
            "-lmm -o out'> <input type='submit' value='run'></form>"
            f"<p style='color:#666'>runs in {html.escape(self.state.workdir)}"
            "</p></div>"
            "<div class='card'><h3>Upload an assoc TSV</h3>"
            "<form method='post' action='/upload'>"
            f"<input type='hidden' name='csrf' value='{self.state.csrf}'>"
            "<input name='name' placeholder='name'> "
            "<input type='submit' value='render'><br>"
            "<textarea name='content' rows='4' cols='90' "
            "placeholder='paste chrom/pos/pwald TSV content'></textarea>"
            "</form></div>"
            "<div class='card'><h3>Jobs (this session)</h3><table>"
            "<tr><th>job</th><th>module</th><th>status</th><th>started</th>"
            f"<th>args</th></tr>{jobs_rows}</table></div>"
            "<div class='card'><h3>Run history</h3><table>"
            "<tr><th>run</th><th>time</th><th>module</th><th>prefix</th>"
            f"<th>wall</th><th>status</th></tr>{hist_rows}</table></div>"
        )
        return _page("janusx-tpu", body)

    def _run_detail(self, run_id: int):
        r = history.get_run(run_id)
        if r is None:
            return self._send(_page("run not found", ""), code=404)
        params = json.loads(r[4] or "{}")
        outputs = json.loads(r[5] or "[]")
        out_html = ""
        for o in outputs:
            link = f"/file?p={urllib.parse.quote(o)}"
            out_html += (
                f"<h4><a href='{link}'>{html.escape(o)}</a></h4>"
                + (_preview(o) if os.path.exists(o) else "<i>missing</i>")
            )
        body = (
            f"<p>{_fmt_ts(r[1])} &middot; module <b>{html.escape(r[2])}</b>"
            f" &middot; status {html.escape(str(r[7]))}</p>"
            f"<pre>{html.escape(json.dumps(params, indent=2))}</pre>"
            f"{out_html}"
        )
        return self._send(_page(f"run #{run_id}", body))

    def _job_detail(self, job_id: int):
        job = self.state.jobs.get(job_id)
        if job is None:
            return self._send(_page("job not found", ""), code=404)
        dur = (job.finished or time.time()) - job.started
        cancel = (
            f"<form method='post' action='/job/{job.id}/cancel'>"
            f"<input type='hidden' name='csrf' value='{self.state.csrf}'>"
            "<input type='submit' value='cancel'></form>"
            if job.status == "running" else ""
        )
        body = (
            f"<p>module <b>{job.module}</b> &middot; "
            f"<span class='status-{job.status}'>{job.status}</span>"
            f" &middot; {dur:.1f}s &middot; args: "
            f"<code>{html.escape(' '.join(job.args))}</code></p>{cancel}"
            f"<h3>log</h3><pre>{html.escape(job.log_tail())}</pre>"
            "<script>if(document.querySelector('.status-running'))"
            "setTimeout(()=>location.reload(), 3000)</script>"
        )
        return self._send(_page(f"job #{job_id}", body))

    @staticmethod
    def _assoc_tsvs(outputs: list) -> list:
        return [o for o in outputs
                if str(o).endswith(".assoc.tsv") and os.path.exists(o)]

    @staticmethod
    def _load_tsv(path: str) -> dict:
        """Tiny stdlib TSV reader (column name -> list of strings).
        pandas' pyarrow string backend is NOT safe inside handler
        threads (observed segfault in _from_sequence), and the server
        must stay importable without heavy deps anyway."""
        import csv

        with open(path, "rt", newline="") as fh:
            rd = csv.reader(fh, delimiter="\t")
            header = next(rd, None)
            if not header:
                raise ValueError(f"{os.path.basename(path)}: empty TSV")
            cols: dict = {h: [] for h in header}
            for row in rd:
                for h, v in zip(header, row):
                    cols[h].append(v)
        return cols

    def _run_outputs(self, run_id: int):
        r = history.get_run(run_id)
        if r is None:
            return None
        return json.loads(r[5] or "[]")

    def _render_run(self, run_id: int):
        """Render Manhattan + QQ for every assoc TSV of a recorded run —
        browser-driven postgwas (reference /api/gwas-history/<id>/render);
        images land next to the TSVs (inside an allowed run root)."""
        outputs = self._run_outputs(run_id)
        if outputs is None:
            return self._send(_page("run not found", ""), code=404)
        tsvs = self._assoc_tsvs(outputs)
        if not tsvs:
            return self._send(
                _page("nothing to render", "run has no assoc TSVs"), code=400)
        import numpy as np

        from janusx_tpu_torch.plots.gwasplots import manhattan_plot, qq_plot

        body = ""
        for t in tsvs:
            cols = self._load_tsv(t)
            if not {"chrom", "pos", "pwald"}.issubset(cols):
                continue
            man = t[: -len(".assoc.tsv")] + ".ui.manhattan.png"
            qq = t[: -len(".assoc.tsv")] + ".ui.qq.png"
            tag = os.path.basename(t)[: -len(".assoc.tsv")]
            manhattan_plot(np.asarray(cols["chrom"]),
                           np.asarray(cols["pos"], float),
                           np.asarray(cols["pwald"], float), man, title=tag)
            lam = qq_plot(np.asarray(cols["pwald"], float), qq, title=tag)
            body += (f"<h4>{html.escape(tag)} (&lambda;={lam:.3f})</h4>"
                     + _preview(man) + _preview(qq))
        body += (f"<p><a href='/run/{run_id}/sigsites'>significant sites"
                 "</a></p>")
        return self._send(_page(f"run #{run_id} plots", body))

    def _sigsites(self, run_id: int, thr: float | None):
        """Significant-site table across the run's assoc TSVs (reference
        /api/gwas-history/<id>/sigsites); default threshold 0.05/m."""
        outputs = self._run_outputs(run_id)
        if outputs is None:
            return self._send(_page("run not found", ""), code=404)
        import numpy as np

        body = ""
        for t in self._assoc_tsvs(outputs):
            cols = self._load_tsv(t)
            if "pwald" not in cols:
                continue
            p = np.asarray(cols["pwald"], float)
            m = max(int(np.isfinite(p).sum()), 1)
            cut = thr if thr is not None else 0.05 / m
            idx = np.nonzero(np.isfinite(p) & (p < cut))[0]
            idx = idx[np.argsort(p[idx], kind="stable")][:500]
            tag = os.path.basename(t)
            body += (f"<h4>{html.escape(tag)} — {len(idx)} sites "
                     f"(p &lt; {cut:.3g})</h4>")
            show = [c for c in ("chrom", "pos", "snp", "af", "beta", "se",
                                "pwald") if c in cols]
            rows = "".join(
                "<tr>" + "".join(
                    f"<td>{html.escape(cols[c][i])}</td>" for c in show
                ) + "</tr>"
                for i in idx)
            body += ("<table><tr>" + "".join(f"<th>{c}</th>" for c in show)
                     + f"</tr>{rows}</table>")
        return self._send(_page(f"run #{run_id} significant sites", body))

    def _upload(self, form: dict):
        """Paste-an-assoc-TSV entry point (reference /api/gwas-upload):
        stores the content under the workdir and renders Manhattan/QQ +
        a sigsites link."""
        name = os.path.basename(form.get("name", ["upload"])[0]) or "upload"
        if not name.endswith(".assoc.tsv"):
            name += ".assoc.tsv"
        content = form.get("content", [""])[0]
        if not content.strip():
            return self._send(_page("error", "empty TSV content"), code=400)
        updir = os.path.join(self.state.workdir, "uploads")
        os.makedirs(updir, exist_ok=True)
        path = os.path.join(updir, name)
        with open(path, "wt") as fh:
            fh.write(content)
        import numpy as np

        from janusx_tpu_torch.plots.gwasplots import manhattan_plot, qq_plot

        try:
            cols = self._load_tsv(path)
            if not {"chrom", "pos", "pwald"}.issubset(cols):
                raise ValueError("needs chrom/pos/pwald columns")
            man = path[: -len(".assoc.tsv")] + ".ui.manhattan.png"
            qq = path[: -len(".assoc.tsv")] + ".ui.qq.png"
            manhattan_plot(np.asarray(cols["chrom"]),
                           np.asarray(cols["pos"], float),
                           np.asarray(cols["pwald"], float), man, title=name)
            lam = qq_plot(np.asarray(cols["pwald"], float), qq, title=name)
        except Exception as e:  # malformed paste -> clean 400, not a 500
            return self._send(_page("error", html.escape(str(e))), code=400)
        body = (f"<p>stored {html.escape(path)} (&lambda;={lam:.3f})</p>"
                + _preview(man) + _preview(qq))
        return self._send(_page(f"upload: {name}", body))

    def _file(self, path: str):
        if not path or not self.state.allowed_file(path):
            return self._send(_page("forbidden", ""), code=403)
        if not os.path.isfile(path):
            return self._send(_page("not found", ""), code=404)
        ctype = {
            ".png": "image/png", ".svg": "image/svg+xml",
            ".json": "application/json", ".html": "text/html",
        }.get(os.path.splitext(path)[1], "text/plain; charset=utf-8")
        with open(path, "rb") as fh:
            self._send(fh.read(), ctype)


def serve(workdir: str = ".", port: int = 8080, bind: str = "127.0.0.1"):
    state = UiState(workdir)
    Handler.state = state
    srv = ThreadingHTTPServer((bind, port), Handler)
    return srv, state
