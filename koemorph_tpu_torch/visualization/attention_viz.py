"""Attention visualization: mel frequency-band heatmaps, stream weights.

The plots of a model's returned attention weights
(``return_attention=True``): heatmaps of the (28 x 80) mouth-query /
mel-channel attention by frequency band and the per-blendshape stream
fusion weights (matplotlib, imported only inside the plotting methods),
scalar stream-specialization metrics, and a self-contained interactive
HTML explorer that needs no plotting library. Every function takes numpy
arrays or tensors (on any device) and works on the host in numpy.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional, Union

import numpy as np

from koemorph_tpu_torch.blendshapes import (
    ARKIT_BLENDSHAPES,
    EXPRESSION_INDICES,
    MOUTH_INDICES,
)

logger = logging.getLogger(__name__)

__all__ = ["frequency_bands", "AttentionVisualizer",
           "create_interactive_attention_html"]


def frequency_bands(n_mels: int = 80, sample_rate: int = 16000,
                    f_min: float = 80.0, f_max: float = 8000.0) -> dict:
    """Mel-channel index ranges ``[lo, hi)`` of named frequency bands, by
    the Slaney-mel centre of each of ``n_mels`` channels."""
    from koemorph_tpu_torch.ops.mel import hz_to_mel, mel_to_hz

    mel_lo, mel_hi = hz_to_mel(np.asarray(f_min)), hz_to_mel(
        np.asarray(f_max))
    centers = mel_to_hz(np.linspace(mel_lo, mel_hi, n_mels))
    bands = {"low (F0)": (0, 1000), "mid (formants)": (1000, 4000),
             "high (fricatives)": (4000, 8000)}
    out = {}
    for name, (lo, hi) in bands.items():
        idx = np.where((centers >= lo) & (centers < hi))[0]
        if len(idx):
            out[name] = (int(idx[0]), int(idx[-1]) + 1)
    return out


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


class AttentionVisualizer:
    """Plots from a model's returned attention weights."""

    def __init__(self, save_dir: Union[str, Path] = "attention_plots"):
        self.save_dir = Path(save_dir)
        self.save_dir.mkdir(parents=True, exist_ok=True)

    def plot_mel_attention(
        self,
        mel_attention: np.ndarray,        # (28, 80) or (B, 28, 80)
        title: str = "Mouth-query attention over mel channels",
        save_name: str = "mel_attention.png",
    ) -> str:
        """Heatmap of mouth queries x mel channels with band annotations."""
        plt = _plt()
        att = _host(mel_attention)
        if att.ndim == 3:
            att = att.mean(axis=0)
        fig, ax = plt.subplots(figsize=(10, 6))
        im = ax.imshow(att, aspect="auto", origin="lower", cmap="viridis")
        ax.set_xlabel("mel channel")
        ax.set_ylabel("mouth blendshape query")
        ax.set_yticks(range(len(MOUTH_INDICES)))
        ax.set_yticklabels(
            [ARKIT_BLENDSHAPES[i] for i in MOUTH_INDICES], fontsize=5)
        for name, (lo, hi) in frequency_bands(att.shape[-1]).items():
            ax.axvline(lo, color="w", lw=0.5, ls="--")
            ax.text(lo + 0.5, att.shape[0] - 1.5, name, color="w",
                    fontsize=6)
        ax.set_title(title)
        fig.colorbar(im, ax=ax)
        out = self.save_dir / save_name
        fig.tight_layout()
        fig.savefig(out, dpi=120)
        plt.close(fig)
        return str(out)

    def plot_stream_weights(
        self,
        mel_weights: np.ndarray,          # (52,) logits
        emotion_weights: np.ndarray,      # (52,) logits
        temperature: float = 1.0,
        save_name: str = "stream_weights.png",
    ) -> str:
        """Per-blendshape softmax stream weights: the mouth/expression
        specialization picture."""
        plt = _plt()
        logits = np.stack([_host(mel_weights),
                           _host(emotion_weights)]) / temperature
        ex = np.exp(logits - logits.max(axis=0, keepdims=True))
        w = ex / ex.sum(axis=0, keepdims=True)
        fig, ax = plt.subplots(figsize=(12, 4))
        x = np.arange(52)
        ax.bar(x, w[0], label="mel stream", color="#3b7dd8")
        ax.bar(x, w[1], bottom=w[0], label="emotion stream",
               color="#d87a3b")
        for i in MOUTH_INDICES:
            ax.axvspan(i - 0.5, i + 0.5, color="k", alpha=0.04)
        ax.set_xticks(x)
        ax.set_xticklabels(ARKIT_BLENDSHAPES, rotation=90, fontsize=5)
        ax.set_ylabel("stream weight")
        ax.legend(loc="upper right")
        ax.set_title("Per-blendshape stream fusion weights "
                     "(shaded = mouth set)")
        out = self.save_dir / save_name
        fig.tight_layout()
        fig.savefig(out, dpi=120)
        plt.close(fig)
        return str(out)

    def specialization_summary(self, mel_weights, emotion_weights,
                               temperature: float = 1.0) -> dict:
        """Scalar stream-specialization metrics (no plotting)."""
        logits = np.stack([_host(mel_weights),
                           _host(emotion_weights)]) / temperature
        ex = np.exp(logits - logits.max(axis=0, keepdims=True))
        w = ex / ex.sum(axis=0, keepdims=True)
        mouth = np.asarray(MOUTH_INDICES)
        expr = np.asarray(EXPRESSION_INDICES)
        return {
            "mel_weight_on_mouth": float(w[0, mouth].mean()),
            "mel_weight_on_expression": float(w[0, expr].mean()),
            "emotion_weight_on_mouth": float(w[1, mouth].mean()),
            "emotion_weight_on_expression": float(w[1, expr].mean()),
            "specialization": float(
                w[0, mouth].mean() + w[1, expr].mean()) / 2,
        }


def _query_labels(n: int, preferred_indices) -> list:
    """Blendshape names for n query rows: the stream's own names first,
    then the full vocabulary, then generic labels (so a (52, K) or larger
    matrix renders instead of crashing)."""
    pool = ([ARKIT_BLENDSHAPES[i] for i in preferred_indices]
            + [b for b in ARKIT_BLENDSHAPES
               if b not in {ARKIT_BLENDSHAPES[i]
                            for i in preferred_indices}])
    return [(pool[i] if i < len(pool) else f"q{i}") for i in range(n)]


def create_interactive_attention_html(
    mel_attention: np.ndarray,          # (28, 80) or (B, 28, 80)
    emotion_attention: Optional[np.ndarray] = None,  # (24, K)
    save_path: Union[str, Path] = "attention_interactive.html",
) -> str:
    """Self-contained interactive HTML attention explorer: a hoverable
    mel-attention heatmap, per-frequency-band mean bars and the emotion
    attention heatmap, as one HTML file with inline SVG and plain
    JavaScript tooltips (no plotting library). Returns the file's path."""
    mel = _host(mel_attention).astype(np.float64)
    if mel.ndim == 3:
        mel = mel.mean(axis=0)
    q, c = mel.shape
    names = _query_labels(q, MOUTH_INDICES)
    bands = frequency_bands(c)

    def color(v, vmax):
        """viridis-ish 3-stop ramp."""
        t = 0.0 if vmax <= 0 else min(max(v / vmax, 0.0), 1.0)
        stops = [(68, 1, 84), (33, 145, 140), (253, 231, 37)]
        if t < 0.5:
            a, b, u = stops[0], stops[1], t * 2
        else:
            a, b, u = stops[1], stops[2], (t - 0.5) * 2
        rgb = [round(a[i] + (b[i] - a[i]) * u) for i in range(3)]
        return f"rgb({rgb[0]},{rgb[1]},{rgb[2]})"

    cw, ch = 11, 14
    vmax = float(mel.max()) or 1.0
    cells = []
    for i in range(q):
        for j in range(c):
            v = float(mel[i, j])
            cells.append(
                f'<rect x="{j*cw}" y="{(q-1-i)*ch}" width="{cw}" '
                f'height="{ch}" fill="{color(v, vmax)}" '
                f'data-t="{names[i]} · mel {j} · {v:.4f}"/>')
    band_rows = []
    bmax = 1e-9
    band_means = {}
    for name, (lo, hi) in bands.items():
        m = float(mel[:, lo:hi].mean()) if hi > lo else 0.0
        band_means[name] = m
        bmax = max(bmax, m)
    for k, (name, m) in enumerate(band_means.items()):
        w = int(260 * m / bmax)
        band_rows.append(
            f'<div class="bar"><span class="lbl">{name}</span>'
            f'<span class="fill" style="width:{w}px"></span>'
            f'<span class="val">{m:.4f}</span></div>')

    emo_html = ""
    if emotion_attention is not None:
        emo = _host(emotion_attention).astype(np.float64)
        if emo.ndim == 3:
            emo = emo.mean(axis=0)
        eq, ek = emo.shape
        enames = _query_labels(eq, EXPRESSION_INDICES)
        emax = float(emo.max()) or 1.0
        ecw = max(14, min(40, 600 // max(ek, 1)))
        ecells = "".join(
            f'<rect x="{j*ecw}" y="{(eq-1-i)*ch}" width="{ecw}" '
            f'height="{ch}" fill="{color(float(emo[i, j]), emax)}" '
            f'data-t="{enames[i]} · token {j} · {float(emo[i, j]):.4f}"/>'
            for i in range(eq) for j in range(ek))
        emo_html = (
            f"<h2>Emotion attention ({eq} expression queries × {ek} "
            f"tokens)</h2><svg width='{ek*ecw}' height='{eq*ch}'>"
            f"{ecells}</svg>")

    html = f"""<!DOCTYPE html><html><head><meta charset="utf-8">
<title>KoeMorph attention</title><style>
body {{ font-family: sans-serif; margin: 24px; }}
svg rect:hover {{ stroke: #fff; stroke-width: 1; }}
#tip {{ position: fixed; background: #222; color: #fff; padding: 4px 8px;
       border-radius: 4px; font-size: 12px; pointer-events: none;
       display: none; }}
.bar {{ display: flex; align-items: center; margin: 2px 0; }}
.lbl {{ width: 110px; font-size: 12px; }}
.fill {{ background: #33918c; height: 12px; display: inline-block; }}
.val {{ margin-left: 6px; font-size: 11px; color: #555; }}
</style></head><body>
<h1>Dual-stream attention</h1>
<h2>Mel attention ({q} mouth queries × {c} mel channels)</h2>
<svg width="{c*cw}" height="{q*ch}">{''.join(cells)}</svg>
<h2>Mean attention per frequency band</h2>
{''.join(band_rows)}
{emo_html}
<div id="tip"></div>
<script>
const tip = document.getElementById('tip');
document.querySelectorAll('rect').forEach(r => {{
  r.addEventListener('mousemove', e => {{
    tip.style.display = 'block';
    tip.style.left = (e.clientX + 12) + 'px';
    tip.style.top = (e.clientY + 12) + 'px';
    tip.textContent = r.dataset.t;
  }});
  r.addEventListener('mouseleave', () => tip.style.display = 'none');
}});
</script></body></html>"""
    out = Path(save_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(html, encoding="utf-8")
    return str(out)
