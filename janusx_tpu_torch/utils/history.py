"""SQLite run-history registry.

Reference: python/janusx/script/_common/gwas_history.py (run registry
backing the web UI). Each workflow invocation records module, arguments,
outputs and timing into ``~/.janusx_tpu/history.db`` (override with
JX_TPU_HISTORY_DB; set to "0" to disable).
"""

from __future__ import annotations

import json
import logging
import os
import sqlite3
import time

log = logging.getLogger("janusx_tpu.history")

_SCHEMA = """
CREATE TABLE IF NOT EXISTS runs (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  ts REAL NOT NULL,
  module TEXT NOT NULL,
  out_prefix TEXT,
  params TEXT,
  outputs TEXT,
  seconds REAL,
  status TEXT
);
"""


def _db_path() -> str | None:
    override = os.environ.get("JX_TPU_HISTORY_DB")
    if override == "0":
        return None
    if override:
        return override
    d = os.path.join(os.path.expanduser("~"), ".janusx_tpu")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, "history.db")


def record_run(
    module: str,
    out_prefix: str | None,
    params: dict,
    outputs: list | None = None,
    seconds: float | None = None,
    status: str = "ok",
) -> None:
    path = _db_path()
    if path is None:
        return
    try:
        con = sqlite3.connect(path, timeout=5)
        con.execute(_SCHEMA)
        con.execute(
            "INSERT INTO runs (ts, module, out_prefix, params, outputs, seconds, status)"
            " VALUES (?, ?, ?, ?, ?, ?, ?)",
            (
                time.time(), module, out_prefix,
                json.dumps(params, default=str),
                json.dumps(outputs or [], default=str),
                seconds, status,
            ),
        )
        con.commit()
        con.close()
    except sqlite3.Error as e:
        log.debug("history record failed: %s", e)


def _query(sql: str, params: tuple, fetchone: bool = False):
    """Read query with graceful degradation: a locked/corrupt history DB
    must not 500 every web-UI request — readers return empty instead."""
    path = _db_path()
    if path is None or not os.path.exists(path):
        return None if fetchone else []
    try:
        con = sqlite3.connect(path, timeout=5)
        try:
            con.execute(_SCHEMA)
            cur = con.execute(sql, params)
            return cur.fetchone() if fetchone else cur.fetchall()
        finally:
            con.close()
    except sqlite3.Error as e:
        log.warning("history read failed: %s", e)
        return None if fetchone else []


def list_runs(limit: int = 100) -> list:
    return _query(
        "SELECT ts, module, out_prefix, seconds, status FROM runs"
        " ORDER BY ts DESC LIMIT ?",
        (limit,),
    )


def list_runs_full(limit: int = 200) -> list:
    """Rows of (id, ts, module, out_prefix, params, outputs, seconds,
    status) for the web UI run registry."""
    return _query(
        "SELECT id, ts, module, out_prefix, params, outputs, seconds, status"
        " FROM runs ORDER BY ts DESC LIMIT ?",
        (limit,),
    )


def list_run_prefixes() -> list:
    """All distinct out_prefix values ever recorded (web-UI artifact-root
    whitelist — must not be truncated to recent runs, or older run pages
    403 on their own artifacts)."""
    rows = _query(
        "SELECT DISTINCT out_prefix FROM runs WHERE out_prefix IS NOT NULL",
        (),
    )
    return [r[0] for r in rows]


def get_run(run_id: int):
    return _query(
        "SELECT id, ts, module, out_prefix, params, outputs, seconds, status"
        " FROM runs WHERE id = ?",
        (run_id,),
        fetchone=True,
    )
