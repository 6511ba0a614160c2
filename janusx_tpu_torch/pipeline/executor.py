"""Checkpointed external-command pipeline executor.

Replaces the reference's generic step executor
(JanusX src/workflow/pipeline.rs:13-45 + fastq2vcf/state.rs:
durable JSON work-state with per-item completion tracking,
resume-from-first-incomplete-step, output-existence skip, nohup/cluster
schedulers).

Each Step runs one shell command per work item; completion is recorded in
``{state_path}`` after every item, so a killed run resumes exactly where
it stopped. ``skip_if_outputs_exist`` short-circuits items whose declared
outputs are already present.
"""

from __future__ import annotations

import json
import logging
import os
import shlex
import subprocess
import time
from dataclasses import dataclass, field
from typing import Callable

log = logging.getLogger("janusx_tpu.pipeline")


@dataclass
class Step:
    name: str
    command: Callable[[dict], str]  # item -> shell command
    outputs: Callable[[dict], list] = lambda item: []
    threads: int = 1


@dataclass
class PipelineOptions:
    skip_if_outputs_exist: bool = True
    dry_run: bool = False
    scheduler: str = "local"  # "local" | "nohup"
    stop_on_error: bool = True
    log_dir: str | None = None


@dataclass
class Pipeline:
    name: str
    steps: list
    items: list  # list[dict] work items (e.g. one per sample)
    state_path: str
    options: PipelineOptions = field(default_factory=PipelineOptions)

    def _load_state(self) -> dict:
        if os.path.exists(self.state_path):
            with open(self.state_path) as fh:
                return json.load(fh)
        return {"pipeline": self.name, "completed": {}}

    def _save_state(self, state: dict) -> None:
        tmp = self.state_path + ".tmp"
        with open(tmp, "wt") as fh:
            json.dump(state, fh, indent=1)
        os.replace(tmp, self.state_path)

    def first_incomplete_step(self) -> int:
        """Index of the first step with any unfinished item (reference
        infer_first_incomplete_step)."""
        state = self._load_state()
        for si, step in enumerate(self.steps):
            done = set(state["completed"].get(step.name, []))
            if any(self._item_key(it) not in done for it in self.items):
                return si
        return len(self.steps)

    @staticmethod
    def _item_key(item: dict) -> str:
        return str(item.get("id", json.dumps(item, sort_keys=True)))

    def run(self) -> dict:
        state = self._load_state()
        os.makedirs(os.path.dirname(os.path.abspath(self.state_path)) or ".", exist_ok=True)
        opts = self.options
        report = {"steps": [], "skipped": 0, "ran": 0, "failed": 0}
        for step in self.steps:
            done = set(state["completed"].setdefault(step.name, []))
            t0 = time.monotonic()
            ran = skipped = failed = 0
            for item in self.items:
                key = self._item_key(item)
                if key in done:
                    skipped += 1
                    continue
                outs = step.outputs(item)
                if opts.skip_if_outputs_exist and outs and all(
                    os.path.exists(o) for o in outs
                ):
                    done.add(key)
                    state["completed"][step.name] = sorted(done)
                    self._save_state(state)
                    skipped += 1
                    continue
                cmd = step.command(item)
                if opts.dry_run:
                    log.info("[dry-run] %s/%s: %s", step.name, key, cmd)
                    ran += 1
                    continue
                log_file = None
                if opts.log_dir:
                    os.makedirs(opts.log_dir, exist_ok=True)
                    log_file = os.path.join(opts.log_dir, f"{step.name}.{key}.log")
                if opts.scheduler == "nohup":
                    # sh -c so pipes/&& inside the step command stay one unit
                    # under nohup and the whole pipeline logs to one file;
                    # the wait below is deliberate — completion tracking
                    # needs the exit code
                    cmd = (
                        f"nohup sh -c {shlex.quote(cmd)} "
                        f"> {shlex.quote(log_file or '/dev/null')} 2>&1"
                    )
                log.info("%s/%s: %s", step.name, key, cmd)
                from janusx_tpu_torch.utils.interrupt import interrupted, register_child

                if interrupted():
                    failed += 1
                    break
                try:
                    if log_file and opts.scheduler == "local":
                        with open(log_file, "wt") as lf:
                            proc = subprocess.Popen(
                                cmd, shell=True, stdout=lf,
                                stderr=subprocess.STDOUT,
                            )
                            register_child(proc)
                            rc = proc.wait()
                            if rc != 0:
                                raise subprocess.CalledProcessError(rc, cmd)
                    else:
                        proc = subprocess.Popen(
                            cmd, shell=True,
                            stdout=subprocess.DEVNULL if log_file is None else None,
                            stderr=subprocess.DEVNULL if log_file is None else None,
                        )
                        register_child(proc)
                        rc = proc.wait()
                        if rc != 0:
                            raise subprocess.CalledProcessError(rc, cmd)
                except subprocess.CalledProcessError as e:
                    failed += 1
                    log.error("%s/%s failed (rc=%s)", step.name, key, e.returncode)
                    if opts.stop_on_error:
                        break
                    continue
                missing = [o for o in outs if not os.path.exists(o)]
                if missing:
                    failed += 1
                    log.error("%s/%s: missing outputs %s", step.name, key, missing)
                    if opts.stop_on_error:
                        break
                    continue
                done.add(key)
                state["completed"][step.name] = sorted(done)
                self._save_state(state)
                ran += 1
            report["steps"].append(
                {"step": step.name, "ran": ran, "skipped": skipped,
                 "failed": failed, "seconds": round(time.monotonic() - t0, 3)}
            )
            report["ran"] += ran
            report["skipped"] += skipped
            report["failed"] += failed
            if failed and opts.stop_on_error:
                break
        return report


def check_tool(name: str, version_args: tuple = ("--version",)) -> dict:
    """Preflight probe for an external tool (reference
    python/janusx/pipeline/tools/check_*.py)."""
    import shutil

    path = shutil.which(name)
    info = {"tool": name, "found": path is not None, "path": path, "version": None}
    if path:
        try:
            out = subprocess.run(
                [name, *version_args], capture_output=True, text=True, timeout=10
            )
            first = (out.stdout or out.stderr).strip().splitlines()
            info["version"] = first[0][:120] if first else None
        except Exception:
            pass
    return info


FASTQ2VCF_TOOLS = ("fastp", "bwa", "samtools", "samblaster", "gatk", "bcftools", "beagle")
