"""Feature extraction: the emotion chain with its fallback levels, the
emotion2vec encoder, and the reference-named extractor APIs (the streaming
mel and eGeMAPS extractors, the batch mel extractor and its inverse)."""

from koemorph_tpu_torch.features.basic import (BASIC_DIM,
                                               basic_emotion_features)
from koemorph_tpu_torch.features.emotion import (
    CONCAT_DIM,
    EMOTION_TO_BLENDSHAPE_MAPPING,
    EmotionExtractor,
    EmotionFrontendConfig,
    PrecomputedEmotionFeatures,
    create_emotion_extractor,
    emotion_features,
    emotion_to_blendshapes,
)
from koemorph_tpu_torch.features.wav2vec2 import (Wav2Vec2Config,
                                                  Wav2Vec2Encoder)
from koemorph_tpu_torch.features.emotion2vec import (
    ConvEmotionEncoder,
    Emotion2VecCache,
    pool_to_fps,
    utterance_embedding,
)
from koemorph_tpu_torch.features.sliding_window import (
    MelAudioBuffer,
    MelSlidingWindowExtractor,
    create_mel_extractor,
)
from koemorph_tpu_torch.features.egemaps_extractor import (
    AudioBuffer,
    EgemapsStreamingExtractor,
    OpenSMILEeGeMAPSExtractor,
    create_egemaps_extractor,
    create_opensmile_extractor,
)
from koemorph_tpu_torch.features.stft import (InverseMelSpectrogram,
                                              MelSpectrogramExtractor)

__all__ = [
    "BASIC_DIM", "basic_emotion_features",
    "CONCAT_DIM", "EMOTION_TO_BLENDSHAPE_MAPPING",
    "EmotionExtractor", "EmotionFrontendConfig",
    "PrecomputedEmotionFeatures", "Wav2Vec2Config", "Wav2Vec2Encoder",
    "create_emotion_extractor", "emotion_features",
    "emotion_to_blendshapes",
    "ConvEmotionEncoder", "Emotion2VecCache", "pool_to_fps",
    "utterance_embedding",
    "MelAudioBuffer", "MelSlidingWindowExtractor", "create_mel_extractor",
    "AudioBuffer", "EgemapsStreamingExtractor",
    "OpenSMILEeGeMAPSExtractor",
    "create_egemaps_extractor", "create_opensmile_extractor",
    "MelSpectrogramExtractor", "InverseMelSpectrogram",
]
