"""Analysis-side plots: attention heatmaps, stream-weight specialization."""

from koemorph_tpu_torch.visualization.attention_viz import (
    AttentionVisualizer,
    create_interactive_attention_html,
    frequency_bands,
)

__all__ = ["AttentionVisualizer", "create_interactive_attention_html",
           "frequency_bands"]
