"""Emotion-processing monitor: the counterpart of
``koemorph_tpu.utils.emotion_monitor`` (reference
src/utils/emotion_monitor.py:22-509).

A thread-safe history of every extraction (backend, timings, process
memory, emotion and blendshape activation statistics), the log of backend
demotions, a markdown report, a JSON export, a latency dashboard (imported
matplotlib only inside :meth:`EmotionProcessingMonitor.
plot_performance_metrics`), and the module-level ``get_monitor()`` /
``initialize_monitor(config)``. ``log_dir`` is created when a report,
export or plot is first written there.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["EmotionProcessingMonitor", "get_monitor", "initialize_monitor"]


class EmotionProcessingMonitor:
    """Thread-safe extraction history + statistics + reporting."""

    def __init__(
        self,
        log_dir: str = "logs/emotion_monitor",
        max_history: int = 1000,
        enable_plotting: bool = True,
        verbose: bool = False,
    ):
        self.log_dir = Path(log_dir)
        self.max_history = max_history
        self.enable_plotting = enable_plotting
        self.verbose = verbose

        self._lock = threading.Lock()
        self.history: deque[dict] = deque(maxlen=max_history)
        self.fallback_events: list[dict] = []
        self.backend_counts: Dict[str, int] = {}
        self.backend_times: Dict[str, list[float]] = {}
        self._active: Dict[int, dict] = {}
        self._next_id = 0
        self.start_time = time.time()

    # -- recording ---------------------------------------------------------

    def log_processing_start(self, backend: str,
                             audio_shape: Optional[tuple] = None,
                             batch_size: int = 1) -> int:
        """Begin one extraction record; returns a token for ..._end."""
        with self._lock:
            token = self._next_id
            self._next_id += 1
            self._active[token] = {
                "backend": backend,
                "audio_shape": list(audio_shape) if audio_shape else None,
                "batch_size": batch_size,
                "t_start": time.time(),
            }
        if self.verbose:
            logger.info("extraction start [%d] backend=%s", token, backend)
        return token

    def log_processing_end(
        self,
        token: int,
        success: bool = True,
        emotion_predictions: Optional[dict] = None,
        blendshape_weights: Optional[np.ndarray] = None,
        error: Optional[str] = None,
    ) -> None:
        now = time.time()
        with self._lock:
            rec = self._active.pop(token, None)
            if rec is None:
                return
            rec.update({
                "t_end": now,
                "duration_ms": (now - rec["t_start"]) * 1e3,
                "success": success,
                "error": error,
                "memory_mb": _process_memory_mb(),
            })
            if emotion_predictions:
                rec["dominant_emotion"] = max(
                    emotion_predictions, key=emotion_predictions.get)
                rec["emotion_predictions"] = dict(emotion_predictions)
            if blendshape_weights is not None:
                w = np.asarray(blendshape_weights)
                rec["blendshape_stats"] = {
                    "mean": float(w.mean()), "max": float(w.max()),
                    "active_count": int((w > 0.1).sum()),
                }
            self.history.append(rec)
            b = rec["backend"]
            self.backend_counts[b] = self.backend_counts.get(b, 0) + 1
            self.backend_times.setdefault(b, []).append(rec["duration_ms"])

    def log_fallback_usage(self, from_backend: str, to_backend: str,
                           reason: str) -> None:
        """Record a runtime backend demotion
        (reference emotion_monitor.py:209-224)."""
        with self._lock:
            self.fallback_events.append({
                "time": time.time(), "from": from_backend,
                "to": to_backend, "reason": reason})
        logger.warning("emotion backend fallback %s -> %s: %s",
                       from_backend, to_backend, reason)

    # -- reporting ---------------------------------------------------------

    def get_statistics(self) -> Dict[str, Any]:
        with self._lock:
            total = len(self.history)
            ok = sum(1 for r in self.history if r.get("success"))
            stats: Dict[str, Any] = {
                "uptime_s": time.time() - self.start_time,
                "total_extractions": total,
                "success_rate": ok / total if total else 1.0,
                "fallback_events": len(self.fallback_events),
                "backends": {},
            }
            for b, times in self.backend_times.items():
                arr = np.asarray(times)
                stats["backends"][b] = {
                    "count": self.backend_counts.get(b, 0),
                    "avg_ms": float(arr.mean()),
                    "p50_ms": float(np.percentile(arr, 50)),
                    "p95_ms": float(np.percentile(arr, 95)),
                    "max_ms": float(arr.max()),
                }
            durs = [r["duration_ms"] for r in self.history]
            if durs:
                stats["avg_processing_ms"] = float(np.mean(durs))
            return stats

    def generate_report(self, save_path: Optional[str] = None) -> str:
        """Markdown report (reference emotion_monitor.py:280-343)."""
        s = self.get_statistics()
        with self._lock:
            recent_fallbacks = list(self.fallback_events)[-20:]
        lines = [
            "# Emotion Processing Report",
            "",
            f"- Uptime: {s['uptime_s']:.1f} s",
            f"- Total extractions: {s['total_extractions']}",
            f"- Success rate: {s['success_rate'] * 100:.1f}%",
            f"- Fallback events: {s['fallback_events']}",
            "",
            "## Backends",
            "",
            "| backend | count | avg ms | p50 ms | p95 ms | max ms |",
            "|---|---|---|---|---|---|",
        ]
        for b, bs in s["backends"].items():
            lines.append(
                f"| {b} | {bs['count']} | {bs['avg_ms']:.2f} | "
                f"{bs['p50_ms']:.2f} | {bs['p95_ms']:.2f} | "
                f"{bs['max_ms']:.2f} |")
        if recent_fallbacks:
            lines += ["", "## Fallback events", ""]
            for e in recent_fallbacks:
                lines.append(f"- {e['from']} -> {e['to']}: {e['reason']}")
        report = "\n".join(lines) + "\n"
        if save_path is None:
            save_path = self._in_log_dir(f"report_{int(time.time())}.md")
        Path(save_path).write_text(report)
        return report

    def plot_performance_metrics(
            self, save_dir: Optional[str] = None) -> Optional[str]:
        """Latency/backend dashboard PNG (gated on matplotlib)."""
        if not self.enable_plotting:
            return None
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            logger.warning("matplotlib unavailable; skipping plots")
            return None
        with self._lock:
            recs = list(self.history)
            counts = dict(self.backend_counts)
        if not recs:
            return None
        fig, axes = plt.subplots(1, 2, figsize=(10, 4))
        axes[0].plot([r["duration_ms"] for r in recs])
        axes[0].set_title("extraction latency (ms)")
        axes[0].set_xlabel("extraction #")
        axes[1].bar(list(counts.keys()), list(counts.values()))
        axes[1].set_title("extractions by backend")
        out = (Path(save_dir) / "performance_metrics.png" if save_dir
               else self._in_log_dir("performance_metrics.png"))
        fig.tight_layout()
        fig.savefig(out, dpi=100)
        plt.close(fig)
        return str(out)

    def export_data(self, export_path: Optional[str] = None) -> str:
        """Full history as JSON (reference emotion_monitor.py:458-476)."""
        path = Path(export_path or
                    self._in_log_dir(f"export_{int(time.time())}.json"))
        with self._lock:
            payload = {
                "history": list(self.history),
                "fallback_events": list(self.fallback_events),
            }
        payload["statistics"] = self.get_statistics()
        path.write_text(json.dumps(payload, indent=2, default=str))
        return str(path)

    def _in_log_dir(self, name: str) -> Path:
        self.log_dir.mkdir(parents=True, exist_ok=True)
        return self.log_dir / name

    def reset_metrics(self) -> None:
        with self._lock:
            self.history.clear()
            self.fallback_events.clear()
            self.backend_counts.clear()
            self.backend_times.clear()
            self._active.clear()
            self.start_time = time.time()


def _process_memory_mb() -> float:
    try:
        import psutil
    except ImportError:
        return 0.0
    return psutil.Process().memory_info().rss / 1e6


_monitor: Optional[EmotionProcessingMonitor] = None
_monitor_lock = threading.Lock()


def get_monitor() -> EmotionProcessingMonitor:
    """Module-level singleton (reference emotion_monitor.py:497-503)."""
    global _monitor
    with _monitor_lock:
        if _monitor is None:
            _monitor = EmotionProcessingMonitor()
        return _monitor


def initialize_monitor(config: Dict[str, Any]) -> EmotionProcessingMonitor:
    """Re-create the singleton from config
    (reference emotion_monitor.py:505-509)."""
    global _monitor
    with _monitor_lock:
        _monitor = EmotionProcessingMonitor(
            log_dir=config.get("log_dir", "logs/emotion_monitor"),
            max_history=config.get("max_history", 1000),
            enable_plotting=config.get("enable_plotting", True),
            verbose=config.get("verbose", False))
        return _monitor
