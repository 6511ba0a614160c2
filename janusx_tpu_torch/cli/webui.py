"""`jx webui` — local analysis dashboard: run history, artifact viewers,
job submission (reference: python/janusx/ui/server.py)."""

from __future__ import annotations

import argparse


def build_parser(prog="jx webui") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=prog, description="Run-history dashboard + job manager"
    )
    p.add_argument("-d", "--dir", "--root", type=str, default=".",
                   help="working directory for submitted jobs "
                        "(reference --root runtime dir)")
    p.add_argument("-port", "--port", type=int, default=8080)
    p.add_argument("-bind", "--bind", "--host", type=str, default="127.0.0.1",
                   help="bind address (reference --host)")
    p.add_argument("--no-browser", action="store_true",
                   help="accepted for reference drop-in compatibility; this "
                        "UI never auto-opens a browser")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from janusx_tpu_torch.ui.server import serve

    srv, state = serve(args.dir, args.port, args.bind)
    print(f"janusx-tpu UI at http://{args.bind}:{args.port}/ "
          f"(jobs run in {state.workdir}; Ctrl-C to stop)")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        for job in state.jobs.values():
            job.cancel()
    return 0
