"""Local experiment tracking (JAX ``train/logging.py``; replaces the
reference's ClearML usage: Task.init, Logger.report_scalar/report_histogram,
task.update_output_model, unet_training/training.py:29,71-77,
forward_func.py:59-65).  Standard library only.

Runs live under ``runs/<project>/<task_name>-<stamp>/``:
  meta.json        task name, tags, config
  scalars.jsonl    one line per report_scalar
  histograms.jsonl one line per report_histogram
Model upload goes through models.modelio.ModelRegistry.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional, Sequence


class RunLogger:
    def __init__(self, project: str, task_name: str,
                 tags: Sequence[str] = (), config: Optional[dict] = None,
                 root: str = "runs"):
        stamp = time.strftime("%Y%m%d-%H%M%S")
        safe = task_name.replace("/", "_").replace(" ", "_")
        self.dir = Path(root) / project.replace("/", "_") / f"{safe}-{stamp}"
        self.dir.mkdir(parents=True, exist_ok=True)
        (self.dir / "meta.json").write_text(json.dumps({
            "project": project, "task_name": task_name, "tags": list(tags),
            "config": config or {}, "created": time.time()}, indent=2))
        self._scalars = open(self.dir / "scalars.jsonl", "a")
        self._hists = open(self.dir / "histograms.jsonl", "a")

    def report_scalar(self, title: str, series: str, value: float,
                      iteration: int) -> None:
        self._scalars.write(json.dumps({
            "title": title, "series": series, "value": float(value),
            "iteration": int(iteration)}) + "\n")
        self._scalars.flush()

    def report_histogram(self, title: str, series: str, iteration: int,
                         values, xlabels=None, xaxis=None, yaxis=None) -> None:
        self._hists.write(json.dumps({
            "title": title, "series": series, "iteration": int(iteration),
            "values": [None if v != v else float(v) for v in values],
            "xlabels": list(xlabels) if xlabels is not None else None,
            "xaxis": xaxis, "yaxis": yaxis}) + "\n")
        self._hists.flush()

    def scalars(self):
        path = self.dir / "scalars.jsonl"
        return [json.loads(line) for line in path.read_text().splitlines() if line]

    def close(self):
        self._scalars.close()
        self._hists.close()
