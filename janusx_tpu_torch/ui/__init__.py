"""Local web UI: run history, artifact viewers, job management."""
