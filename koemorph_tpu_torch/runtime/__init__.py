"""Real-time streaming runtime: one session per engine or many sessions in
one batched step, the device-resident stream state and its per-frame
step, and the host audio sources (WAV replay, microphone capture through
the optional ``pyaudio``) and output shells."""

from koemorph_tpu_torch.runtime.streaming import (
    StreamingConfig,
    StreamingInference,
    StreamState,
    init_stream_state,
    stream_frame,
)
from koemorph_tpu_torch.runtime.streamers import (BlendshapeStreamer,
                                                  encode_osc_message)
from koemorph_tpu_torch.runtime.audio import (HAS_PYAUDIO, AudioFileReader,
                                              MicCapture, list_audio_devices)
from koemorph_tpu_torch.runtime.engine import run_realtime_loop
from koemorph_tpu_torch.runtime.multistream import MultiStreamInference

__all__ = [
    "StreamingConfig", "StreamState", "StreamingInference",
    "MultiStreamInference",
    "init_stream_state", "stream_frame",
    "BlendshapeStreamer", "encode_osc_message",
    "AudioFileReader", "MicCapture", "HAS_PYAUDIO", "list_audio_devices",
    "run_realtime_loop",
]
