"""PyTorch port: the package surface, the twin of
``tests/test_api_surface.py`` over the port's package names, and the
reference's call-style losses and blendshape helpers against the JAX
package's.

Every name a JAX package ``__init__`` exports is exported by the port's
counterpart, except the ones listed in ``NOT_YET`` with the reason. The
call-style losses are held against JAX's at rtol 1e-5 (the losses tests'
bound: float32 means in another order); the blendshape helpers are equal.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import koemorph_tpu
from koemorph_tpu import blendshapes as jbs
from koemorph_tpu.models import losses as jlosses
from koemorph_tpu_torch import blendshapes as bs
from koemorph_tpu_torch.models import losses

SURFACE = {
    "koemorph_tpu_torch.blendshapes": [
        "ARKIT_BLENDSHAPES", "MOUTH_BLENDSHAPES", "MOUTH_INDICES",
        "EXPRESSION_INDICES",
    ],
    "koemorph_tpu_torch.data": [
        "ARKitDataLoader", "validate_data_consistency",
        "KoeMorphDataset", "collate_fn", "KoeMorphDataModule",
        "SequentialKoeMorphDataset", "SequentialBatchSampler",
        "create_sequential_dataloader", "AdaptiveSequentialDataset",
        "create_adaptive_dataloader",
    ],
    "koemorph_tpu_torch.features": [
        "MelSpectrogramExtractor", "InverseMelSpectrogram",
        "MelAudioBuffer", "MelSlidingWindowExtractor",
        "create_mel_extractor",
        "AudioBuffer", "OpenSMILEeGeMAPSExtractor",
        "create_opensmile_extractor",
        "EmotionExtractor", "EMOTION_TO_BLENDSHAPE_MAPPING",
        "create_emotion_extractor",
        "Emotion2VecCache",
    ],
    "koemorph_tpu_torch.models": [
        "DualStreamCrossAttention", "DualStreamEncoder",
        "SimplifiedDualStreamModel", "SequentialDualStreamModel",
        "MultiHeadCrossAttention", "create_attention_mask",
        "MultiStreamAudioEncoder", "PositionalEncoding",
        "BlendshapeQueryEmbedding",
        "BlendshapeDecoder", "TemporalSmoother", "BlendshapeConstraints",
        "validate_blendshape_output",
        "KoeMorphLoss", "PerceptualBlendshapeLoss",
        "LandmarkConsistencyLoss", "BlendshapeMetrics",
        "compute_lip_sync_metrics",
        "KoeMorphModel", "create_koemorph_model",
        "SimplifiedKoeMorphModel",
    ],
    "koemorph_tpu_torch.ops": [
        "compute_reconstruction_snr", "validate_mel_parameters",
        "yin_f0",
    ],
    "koemorph_tpu_torch.utils": [
        "EmotionProcessingMonitor", "get_monitor",
    ],
    "koemorph_tpu_torch.train": [
        "KoeMorphTrainer", "DualStreamTrainer", "SequentialTrainer",
    ],
    "koemorph_tpu_torch.utils.profiling": [
        "FrameTimer", "benchmark", "trace", "rtf_report", "fetch_scalar",
        "measure_rtt", "scan_timed",
    ],
    "koemorph_tpu_torch.utils.trace_latency": [
        "parse_device_durations", "capture_step_trace", "summarize_ms",
    ],
    "koemorph_tpu_torch.parallel.mesh": [
        "batch_leading_size", "pad_batch_to_size", "pad_batch_to_multiple",
        "DATA_AXIS", "make_mesh", "batch_sharding", "replicated_sharding",
        "shard_batch", "replicate", "local_batch_size",
    ],
}

#: JAX names the port does not export yet, and why
NOT_YET = {
    # Flax train state: ROADMAP.md "Not to port"
    "koemorph_tpu.train": {"TrainState", "create_train_state"},
    # the tensor-parallel helpers (parallel/tp.py): ROADMAP.md section 1,
    # the tensor-parallel trainer, queued
    "koemorph_tpu.parallel": {
        "MODEL_AXIS", "TP_RULES", "make_mesh_2d",
        "partition_spec_for", "shard_tree", "tree_partition_specs",
        "tree_shardings"},
}


@pytest.mark.parametrize("module,names", sorted(SURFACE.items()))
def test_reference_surface_importable(module, names):
    mod = importlib.import_module(module)
    missing = [n for n in names if not hasattr(mod, n)]
    assert not missing, f"{module} missing reference symbols: {missing}"


@pytest.mark.parametrize("sub", ["", ".data", ".features", ".models",
                                 ".ops", ".parallel", ".runtime", ".train",
                                 ".utils", ".visualization", ".export"])
def test_jax_exports_are_exported(sub):
    """Each JAX ``__init__``'s ``__all__`` against the port's, less
    ``NOT_YET``."""
    jmod = importlib.import_module("koemorph_tpu" + sub)
    mod = importlib.import_module("koemorph_tpu_torch" + sub)
    skip = NOT_YET.get("koemorph_tpu" + sub) or set()
    want = set(jmod.__all__) - skip
    if sub == ".export":
        # TensorFlow's SavedModel / TFLite: the port exports pt2
        want -= {"export_savedmodel", "export_tflite"}
        want |= {"export_program", "load_program"}
    missing = sorted(want - set(mod.__all__))
    assert not missing, f"koemorph_tpu_torch{sub} lacks {missing}"
    assert all(hasattr(mod, n) for n in mod.__all__)


def test_prosody_functions_available():
    from koemorph_tpu_torch.ops.prosody import (  # noqa: F401
        denormalize_prosody,
        extract_prosody,
        normalize_prosody,
    )


def test_top_level_constants_match_jax():
    import koemorph_tpu_torch as pkg

    for name in koemorph_tpu.__all__:
        assert getattr(pkg, name) == getattr(koemorph_tpu, name), name


def test_blendshape_helpers_match_jax():
    np.testing.assert_array_equal(bs.mouth_index_array(),
                                  jbs.mouth_index_array())
    np.testing.assert_array_equal(bs.expression_index_array(),
                                  jbs.expression_index_array())
    assert bs.mouth_index_array().dtype == np.int32
    for name in ("jawOpen", "eyeBlinkLeft", "tongueOut"):
        assert bs.blendshape_index(name) == jbs.blendshape_index(name)
    with pytest.raises(ValueError, match="notAShape"):
        bs.blendshape_index("notAShape")


def _frames(seed: int):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (4, 52)).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("weights", [{}, {"temporal_weight": 0.3,
                                          "velocity_weight": 0.2,
                                          "landmark_weight": 0.1,
                                          "active_weight": 3.0}])
def test_call_style_losses_match_jax(weights):
    pred, target, prev_p, prev_t = _frames(1)
    audio = np.random.default_rng(2).standard_normal((4, 6, 80)).astype(
        np.float32)
    t = [torch.from_numpy(x) for x in (pred, target, prev_p, prev_t, audio)]
    j = [jnp.asarray(x) for x in (pred, target, prev_p, prev_t, audio)]
    total, metrics = losses.KoeMorphLoss(**weights)(*t)
    jtotal, jmetrics = jlosses.KoeMorphLoss(**weights)(*j)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    assert set(metrics) == set(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(
        float(losses.PerceptualBlendshapeLoss()(t[0], t[1], t[4])),
        float(jlosses.PerceptualBlendshapeLoss()(j[0], j[1], j[4])),
        rtol=1e-5)
    np.testing.assert_allclose(
        float(losses.LandmarkConsistencyLoss()(t[0], t[1])),
        float(jlosses.LandmarkConsistencyLoss()(j[0], j[1])), rtol=1e-5)
    with pytest.raises(ValueError, match="reduction"):
        losses.KoeMorphLoss(reduction="sum")
