"""The emotion frontend: its configuration, the device-side feature
vector of an utterance (the ``egemaps`` and ``basic`` backends; the
``emotion2vec`` backend's encoder carries trained parameters and runs
through the model), precomputed emotion2vec features on disk, and the
host-facing :class:`EmotionExtractor` with its emotion heuristics, the
counterpart of ``koemorph_tpu.features.emotion``."""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import pickle
import time
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from koemorph_tpu_torch.blendshapes import ARKIT_BLENDSHAPES
from koemorph_tpu_torch.device import DeviceLike, resolve_device
from koemorph_tpu_torch.features.basic import (BASIC_DIM,
                                               basic_emotion_features)
from koemorph_tpu_torch.ops.cuda import KernelError
from koemorph_tpu_torch.ops.egemaps import NUM_FEATURES as EGEMAPS_DIM
from koemorph_tpu_torch.ops.egemaps import (EgemapsConfig,
                                            egemaps_concat_windows,
                                            egemaps_functionals)

logger = logging.getLogger(__name__)

CONCAT_DIM = EGEMAPS_DIM * 3  # 264: functionals over 3 offset windows

#: emotion category labels (reference emotion_extractor.py:24-27)
EMOTION2VEC_LABELS = {
    0: "angry", 1: "disgusted", 2: "fearful", 3: "happy",
    4: "neutral", 5: "other", 6: "sad", 7: "surprised", 8: "unknown",
}

#: emotion -> expression-blendshape heuristic map
#: (reference emotion_extractor.py:30-61)
EMOTION_TO_BLENDSHAPE_MAPPING: dict[str, dict[str, float]] = {
    "angry": {
        "browDownLeft": 0.8, "browDownRight": 0.8,
        "eyeSquintLeft": 0.6, "eyeSquintRight": 0.6,
        "noseSneerLeft": 0.4, "noseSneerRight": 0.4,
    },
    "happy": {
        "eyeSquintLeft": 0.3, "eyeSquintRight": 0.3,
        "cheekSquintLeft": 0.7, "cheekSquintRight": 0.7,
        "browOuterUpLeft": 0.2, "browOuterUpRight": 0.2,
    },
    "sad": {"browInnerUp": 0.7, "eyeSquintLeft": 0.4, "eyeSquintRight": 0.4},
    "surprised": {
        "browInnerUp": 0.5, "browOuterUpLeft": 0.8, "browOuterUpRight": 0.8,
        "eyeWideLeft": 0.9, "eyeWideRight": 0.9,
    },
    "fearful": {
        "browInnerUp": 0.9, "browOuterUpLeft": 0.6, "browOuterUpRight": 0.6,
        "eyeWideLeft": 0.7, "eyeWideRight": 0.7,
    },
    "disgusted": {
        "browDownLeft": 0.5, "browDownRight": 0.5,
        "noseSneerLeft": 0.8, "noseSneerRight": 0.8,
        "eyeSquintLeft": 0.6, "eyeSquintRight": 0.6,
    },
    "neutral": {}, "other": {}, "unknown": {},
}


@dataclasses.dataclass(frozen=True)
class EmotionFrontendConfig:
    """Static emotion-frontend configuration: the ``egemaps``, ``basic``
    and ``emotion2vec`` backends."""

    backend: str = "egemaps"
    use_concatenation: bool = True   # 3-window concatenation (production)
    sample_rate: int = 16000
    window_offsets: tuple[float, ...] = (0.0, 0.3, 0.6)
    # egemaps backend: False selects the frame-level jitter and shimmer
    # (EgemapsConfig.per_period_voice_quality)
    egemaps_per_period: bool = True

    def __post_init__(self):
        if self.backend not in ("egemaps", "basic", "emotion2vec"):
            raise ValueError(f"Unknown emotion backend: {self.backend}")

    @property
    def feature_dim(self) -> int:
        if self.backend == "emotion2vec":
            return 1024
        if self.backend == "basic":
            return BASIC_DIM
        return CONCAT_DIM if self.use_concatenation else EGEMAPS_DIM


def emotion_features(audio: torch.Tensor,
                     cfg: EmotionFrontendConfig = EmotionFrontendConfig(),
                     *, egemaps_cfg: EgemapsConfig | None = None
                     ) -> torch.Tensor:
    """Emotion feature vector ``(..., L) -> (..., D)``: the 3-offset
    concatenated eGeMAPS functionals (264-D), the 88-D functionals of the
    whole audio without concatenation, or the 9-D ``basic`` features.
    The ``emotion2vec`` backend has trained parameters: it raises here and
    runs through the model's encoder."""
    if cfg.backend == "basic":
        return basic_emotion_features(audio, cfg.sample_rate)
    if cfg.backend == "emotion2vec":
        raise ValueError(
            f"Backend {cfg.backend!r} has trained parameters; call it "
            "through the model, not this function")
    ecfg = egemaps_cfg or EgemapsConfig(
        sample_rate=cfg.sample_rate,
        per_period_voice_quality=cfg.egemaps_per_period)
    if cfg.use_concatenation:
        return egemaps_concat_windows(audio, ecfg, cfg.window_offsets)
    return egemaps_functionals(audio, ecfg)


class PrecomputedEmotionFeatures:
    """1024-D emotion2vec features computed offline and stored as ``.npy``
    files ``<dir>/<audio_hash>.npy``, keyed by
    :meth:`~koemorph_tpu_torch.features.emotion2vec.Emotion2VecCache.
    compute_audio_hash` of the float32 audio; each file is ``(1024,)`` (an
    utterance) or ``(T, 1024)`` (a sequence, mean-pooled at lookup)."""

    def __init__(self, directory: Union[str, Path]):
        self.directory = Path(directory)
        if not self.directory.is_dir():
            raise FileNotFoundError(
                f"precomputed emotion feature dir missing: {directory}")

    @staticmethod
    def save(directory: Union[str, Path], audio: np.ndarray,
             features: np.ndarray) -> Path:
        """Record the features of an utterance; returns the file."""
        from koemorph_tpu_torch.features.emotion2vec import Emotion2VecCache

        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        key = Emotion2VecCache.compute_audio_hash(
            np.asarray(audio, np.float32))
        path = directory / f"{key}.npy"
        np.save(path, np.asarray(features, np.float32))
        return path

    def lookup(self, audio: np.ndarray) -> np.ndarray:
        """The ``(1024,)`` features of ``audio``; ``KeyError`` when none
        were recorded."""
        from koemorph_tpu_torch.features.emotion2vec import Emotion2VecCache

        key = Emotion2VecCache.compute_audio_hash(
            np.asarray(audio, np.float32))
        path = self.directory / f"{key}.npy"
        if not path.exists():
            raise KeyError(f"no precomputed emotion features for {key}")
        feats = np.load(path)
        if feats.ndim == 2:
            feats = feats.mean(axis=0)
        return feats.astype(np.float32)


# ---------------------------------------------------------------------------
# heuristics (host-side numpy)
# ---------------------------------------------------------------------------

def emotion_to_blendshapes(predictions: dict[str, float]) -> np.ndarray:
    """Emotion predictions -> 52 blendshape weights in [0, 1]
    (reference emotion_extractor.py:697-717)."""
    weights = np.zeros(len(ARKIT_BLENDSHAPES), dtype=np.float32)
    for emotion, confidence in predictions.items():
        mapping = EMOTION_TO_BLENDSHAPE_MAPPING.get(emotion)
        if not mapping:
            continue
        for name, w in mapping.items():
            weights[ARKIT_BLENDSHAPES.index(name)] += confidence * w
    return np.clip(weights, 0.0, 1.0)


def egemaps_to_emotion(features: np.ndarray) -> dict[str, float]:
    """Arousal / valence heuristics over the 88-D functionals
    (reference emotion_extractor.py:570-621, with thresholds on the
    coefficient-of-variation scale of ``f[1]`` / ``f[13]``)."""
    f = np.asarray(features).reshape(-1)
    if len(f) < 31:
        return {"neutral": 0.8, "other": 0.2}
    f0_mean, f0_std = f[0], f[1]
    loud_std = f[13]
    jitter, shimmer = f[10], f[22]
    hnr = f[24]

    arousal = 0.0
    if f0_std > 0.06 and loud_std > 0.25:
        arousal += 0.4
    if jitter > 0.005 or shimmer > 0.05:
        arousal += 0.3
    valence = 0.0
    if f0_mean > 35 and hnr > 10:       # semitone scale: 35 st ~ 207 Hz
        valence += 0.4
    elif f0_mean < 28 and hnr < 5:      # 28 st ~ 139 Hz
        valence -= 0.4

    if arousal > 0.5 and valence > 0.2:
        return {"happy": 0.6, "surprised": 0.2, "neutral": 0.2}
    if arousal > 0.5 and valence < -0.2:
        return {"angry": 0.5, "fearful": 0.3, "neutral": 0.2}
    if arousal < 0.2 and valence < -0.2:
        return {"sad": 0.6, "neutral": 0.4}
    if arousal > 0.3 and abs(valence) < 0.2:
        return {"surprised": 0.5, "neutral": 0.5}
    return {"neutral": 0.8, "other": 0.2}


def egemaps_to_expression_blendshapes(features: np.ndarray) -> np.ndarray:
    """The 88-D functionals -> expression blendshapes directly
    (reference emotion_extractor.py:623-675)."""
    weights = np.zeros(len(ARKIT_BLENDSHAPES), dtype=np.float32)
    f = np.asarray(features).reshape(-1)
    if len(f) < 14:
        return weights
    f0_std, loud_mean, loud_std = f[1], f[12], f[13]
    f0_var_norm = float(np.clip(f0_std / 0.15, 0, 1))
    energy_norm = float(np.clip(loud_mean / 2.0, 0, 1))
    energy_var_norm = float(np.clip(loud_std / 0.5, 0, 1))

    def setw(name, value):
        weights[ARKIT_BLENDSHAPES.index(name)] = max(0.0, value)

    setw("browInnerUp", f0_var_norm * 0.6)
    brow = (1 - energy_norm) * f0_var_norm * 0.5
    setw("browDownLeft", brow)
    setw("browDownRight", brow)
    eye = f0_var_norm * energy_var_norm * 0.4
    setw("eyeWideLeft", eye)
    setw("eyeWideRight", eye)
    cheek = energy_norm * (1 - f0_var_norm) * 0.3
    setw("cheekSquintLeft", cheek)
    setw("cheekSquintRight", cheek)
    return np.clip(weights, 0.0, 1.0)


def basic_emotion_heuristic(energy, zcr, f0_mean, f0_std) -> dict[str, float]:
    """Emotion guess from the ``basic`` features (reference
    emotion_extractor.py:677-695)."""
    if energy > 0.1 and f0_std > 50:
        return {"angry": 0.6, "neutral": 0.4}
    if energy > 0.05 and f0_mean > 200:
        return {"happy": 0.5, "surprised": 0.3, "neutral": 0.2}
    if energy < 0.01:
        return {"sad": 0.6, "neutral": 0.4}
    return {"neutral": 0.8, "other": 0.2}


# ---------------------------------------------------------------------------
# the host-facing extractor
# ---------------------------------------------------------------------------

_LEVEL_BACKENDS = {0: "emotion2vec", 1: "egemaps", 2: "basic"}
_LEVEL_NAMES = {0: "emotion2vec", 1: "opensmile", 2: "basic"}


def _fresh_stats() -> dict:
    return {"total_calls": 0, "total_processed": 0, "success_rate": 1.0,
            "cache_hits": 0, "emotion2vec_calls": 0, "fallback_calls": 0,
            "avg_processing_time": 0.0}


class EmotionExtractor:
    """Per-utterance emotion features with fallback levels, an on-disk
    cache and statistics (the reference's ``EmotionExtractor``).

    ``fallback_level``: 0 = emotion2vec, 1 = eGeMAPS, 2 = ``basic``.
    Level 0's sources, in order: a local HuggingFace checkpoint
    (``pretrained_path``, read by ``load_hf_checkpoint``; a failure to
    load is logged and the next source tried), the state dict of a
    :class:`~koemorph_tpu_torch.features.emotion2vec.ConvEmotionEncoder`
    (``emotion2vec_params``), then precomputed features
    (``precomputed_dir``). Without any the extractor starts at level 1. A
    failure while extracting demotes one level and retries (logged to the
    emotion monitor); a miss in the precomputed store serves that batch
    from the next level and restores level 0 for the next batch.

    The features are computed on ``device`` (``cuda`` unless asked
    otherwise; raises when CUDA is absent); what the extractor returns is
    numpy on the host. With ``cache_dir`` each utterance's result is
    pickled under the SHA-1 of its float32 bytes.
    """

    def __init__(
        self,
        backend: str = "emotion2vec",
        model_name: str = "conv_emotion_encoder",
        device: DeviceLike = None,
        cache_dir: Optional[Union[str, Path]] = None,
        enable_caching: bool = True,
        batch_size: int = 4,
        sample_rate: int = 16000,
        emotion2vec_params: Optional[dict] = None,
        use_concatenation: bool = True,
        pretrained_path: Optional[Union[str, Path]] = None,
        precomputed_dir: Optional[Union[str, Path]] = None,
    ):
        self.backend = backend
        self.model_name = model_name
        self.device = resolve_device(device)
        self.cache_dir = Path(cache_dir) if cache_dir else None
        self.enable_caching = enable_caching and self.cache_dir is not None
        self.batch_size = batch_size
        self.sample_rate = sample_rate
        self.use_concatenation = use_concatenation
        self._e2v_params = emotion2vec_params
        self._e2v_module: Optional[torch.nn.Module] = None
        self._precomputed = (
            PrecomputedEmotionFeatures(precomputed_dir)
            if precomputed_dir is not None else None)

        if backend == "emotion2vec":
            if pretrained_path is not None:
                try:
                    from koemorph_tpu_torch.features.wav2vec2 import (
                        Wav2Vec2Encoder, load_hf_checkpoint)

                    w2v_cfg, sd = load_hf_checkpoint(pretrained_path)
                    module = Wav2Vec2Encoder(w2v_cfg, use_layer_fusion=True)
                    module.load_state_dict(sd)
                    self._e2v_module = module.to(self.device).eval()
                    self._e2v_params = None     # loaded
                except Exception as e:
                    logger.warning(
                        "pretrained emotion2vec weights unavailable (%s)", e)
            if self._e2v_module is None and emotion2vec_params is not None:
                from koemorph_tpu_torch.features.emotion2vec import (
                    ConvEmotionEncoder)
                self._e2v_module = ConvEmotionEncoder()
            if self._e2v_module is not None or self._precomputed is not None:
                self.fallback_level = 0
            else:
                logger.info("no emotion2vec source available; falling back "
                            "to the eGeMAPS backend")
                self.fallback_level = 1
        elif backend in ("opensmile", "egemaps"):
            self.fallback_level = 1
        else:
            self.fallback_level = 2

        if self.enable_caching:
            self.cache_dir.mkdir(parents=True, exist_ok=True)
        self.extraction_stats = _fresh_stats()

    def frontend_config(self) -> EmotionFrontendConfig:
        """The frontend of the current level."""
        return EmotionFrontendConfig(
            backend=_LEVEL_BACKENDS[self.fallback_level],
            use_concatenation=self.use_concatenation,
            sample_rate=self.sample_rate)

    @property
    def feature_dim(self) -> int:
        return self.frontend_config().feature_dim

    def _get_backend_name(self) -> str:
        return _LEVEL_NAMES[self.fallback_level]

    # -- extraction ---------------------------------------------------------

    def extract_features(self, audio, return_embeddings: bool = True,
                         return_predictions: bool = True) -> dict:
        """``audio`` ``(L,)`` or ``(B, L)`` -> ``{"metadata",
        "blendshape_weights" (B, 52), "embeddings" (B, D), "predictions"
        (B dicts)}``; an utterance no level could serve gets zeros."""
        from koemorph_tpu_torch.utils.emotion_monitor import get_monitor

        start = time.time()
        self.extraction_stats["total_calls"] += 1
        audio_np = np.asarray(audio, dtype=np.float32)
        if audio_np.ndim == 1:
            audio_np = audio_np[None]
        b = audio_np.shape[0]
        monitor = get_monitor()
        token = monitor.log_processing_start(
            self._get_backend_name(), audio_shape=audio_np.shape,
            batch_size=b)

        def run_batch():
            embeddings, predictions, blendshapes = [], [], []
            for sample in audio_np:
                cached = self._load_from_cache(sample)
                if cached is not None and \
                        len(cached["embeddings"]) == self.feature_dim:
                    self.extraction_stats["cache_hits"] += 1
                    result = cached
                else:
                    result = self._extract_one(sample)
                    if result is not None:
                        self._save_to_cache(sample, result)
                if result is None:
                    embeddings.append(
                        np.zeros(self.feature_dim, dtype=np.float32))
                    predictions.append({})
                    blendshapes.append(np.zeros(52, dtype=np.float32))
                else:
                    embeddings.append(result["embeddings"])
                    predictions.append(result["predictions"])
                    blendshapes.append(result["blendshape_weights"])
            return embeddings, predictions, blendshapes

        try:
            # a demotion mid-batch changes the embedding width: rerun the
            # batch until the level holds (at most twice over 3 levels)
            restore_level = (
                self.fallback_level
                if (self.fallback_level == 0 and self._e2v_module is None
                    and self._precomputed is not None)
                else None)
            for _ in range(3):
                level_before = self.fallback_level
                embeddings, predictions, blendshapes = run_batch()
                if self.fallback_level == level_before:
                    break
            served_backend = self._get_backend_name()
            # a precomputed-store miss concerns this batch's utterances
            # only: later batches of known utterances get level 0 again
            if restore_level is not None \
                    and self.fallback_level != restore_level:
                logger.info(
                    "precomputed emotion features missing for this batch; "
                    "served level-%d fallback, restoring emotion2vec for "
                    "future batches", self.fallback_level)
                self.fallback_level = restore_level
        except Exception:
            monitor.log_processing_end(token, success=False,
                                       error="batch extraction failed")
            raise

        out = {
            "metadata": {
                "backend_used": served_backend,
                "processing_time": time.time() - start,
                "cache_used": self.extraction_stats["cache_hits"] > 0,
            },
            "blendshape_weights": np.stack(blendshapes),
        }
        if return_embeddings:
            out["embeddings"] = np.stack(embeddings)
        if return_predictions:
            out["predictions"] = predictions

        self.extraction_stats["total_processed"] += b
        n = self.extraction_stats["total_calls"]
        self.extraction_stats["avg_processing_time"] = (
            (self.extraction_stats["avg_processing_time"] * (n - 1)
             + out["metadata"]["processing_time"]) / n)
        monitor.log_processing_end(
            token, success=any(np.any(e) for e in embeddings),
            emotion_predictions=predictions[0] if predictions else None,
            blendshape_weights=out["blendshape_weights"][0])
        return out

    @torch.no_grad()
    def _embed_emotion2vec(self, sample: np.ndarray) -> np.ndarray:
        from koemorph_tpu_torch.features.emotion2vec import (
            utterance_embedding)

        if self._e2v_module is None:
            if self._precomputed is None:
                raise RuntimeError("no emotion2vec source")
            return self._precomputed.lookup(sample)
        if self._e2v_params is not None:     # ConvEmotionEncoder weights
            self._e2v_module.load_state_dict(self._e2v_params)
            self._e2v_module = self._e2v_module.to(self.device).eval()
            self._e2v_params = None
        feats = self._e2v_module(torch.from_numpy(sample[None]).to(
            self.device))
        return utterance_embedding(feats)[0].cpu().numpy()

    def _extract_one(self, sample: np.ndarray) -> Optional[dict]:
        try:
            if self.fallback_level == 0:
                self.extraction_stats["emotion2vec_calls"] += 1
                emb = self._embed_emotion2vec(sample)
                preds = {"neutral": 0.6, **{k: 0.05 for k in
                                            ("happy", "sad", "angry")}}
                return {"embeddings": emb, "predictions": preds,
                        "blendshape_weights": emotion_to_blendshapes(preds)}
            self.extraction_stats["fallback_calls"] += 1
            x = torch.from_numpy(sample).to(self.device)
            if self.fallback_level == 1:
                emb = emotion_features(x, self.frontend_config()).cpu().numpy()
                preds = egemaps_to_emotion(emb[:88])
                bw = emotion_to_blendshapes(preds)
                bw = 0.7 * bw + 0.3 * egemaps_to_expression_blendshapes(
                    emb[:88])
                return {"embeddings": emb, "predictions": preds,
                        "blendshape_weights": np.clip(bw, 0, 1)}
            emb = basic_emotion_features(x, self.sample_rate).cpu().numpy()
            preds = basic_emotion_heuristic(emb[0], emb[1], emb[3], emb[4])
            return {"embeddings": emb, "predictions": preds,
                    "blendshape_weights": emotion_to_blendshapes(preds)}
        except KernelError:
            # a kernel that fails to build or launch is a fault of the card,
            # not of this backend: no lower level may hide it
            raise
        except Exception as e:  # runtime demotion (reference :427-431)
            logger.warning("Emotion extraction failed at level %d: %s",
                           self.fallback_level, e)
            if self.fallback_level < 2:
                from koemorph_tpu_torch.utils.emotion_monitor import (
                    get_monitor)
                prev = self._get_backend_name()
                self.fallback_level += 1
                get_monitor().log_fallback_usage(
                    prev, self._get_backend_name(), str(e))
                return self._extract_one(sample)
            return None

    # -- caching ------------------------------------------------------------

    def _cache_path(self, audio: np.ndarray) -> Optional[Path]:
        if not self.enable_caching:
            return None
        h = hashlib.sha1(np.ascontiguousarray(audio).tobytes()).hexdigest()
        return self.cache_dir / f"emotion_{h}.pkl"

    def _load_from_cache(self, audio: np.ndarray) -> Optional[dict]:
        p = self._cache_path(audio)
        if p is not None and p.exists():
            try:
                with open(p, "rb") as f:
                    return pickle.load(f)
            except (OSError, pickle.UnpicklingError, EOFError):
                return None
        return None

    def _save_to_cache(self, audio: np.ndarray, result: dict) -> None:
        p = self._cache_path(audio)
        if p is None:
            return
        try:
            with open(p, "wb") as f:
                pickle.dump(result, f)
        except OSError as e:
            logger.debug("Failed to cache results: %s", e)

    def get_statistics(self) -> dict:
        return self.extraction_stats.copy()

    def reset_statistics(self) -> None:
        self.extraction_stats = _fresh_stats()


def create_emotion_extractor(config: dict) -> EmotionExtractor:
    """An :class:`EmotionExtractor` from a config dict (reference
    emotion_extractor.py:777-787); the device defaults to ``cuda``."""
    return EmotionExtractor(
        backend=config.get("backend", "emotion2vec"),
        model_name=config.get("model_name", "conv_emotion_encoder"),
        device=config.get("device"),
        cache_dir=config.get("cache_dir"),
        enable_caching=config.get("enable_caching", True),
        batch_size=config.get("batch_size", 4),
        sample_rate=config.get("sample_rate", 16000),
        emotion2vec_params=config.get("emotion2vec_params"),
        use_concatenation=config.get("use_concatenation", True),
    )
