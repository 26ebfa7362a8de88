"""Signal-processing operators (PyTorch): framing, spectra, the log-mel
frontends, F0 and eGeMAPS, and the CUDA kernels under them
(:mod:`koemorph_tpu_torch.ops.cuda`).

Public surface, the reference's ``koemorph_tpu.ops`` names:

- framing and windows: :func:`frame_signal`, :func:`hann_window`,
  :func:`num_frames` (and :func:`pad_center_reflect` in ``ops.window``);
- spectra: :func:`stft_power` (``method`` ``"matmul"`` or ``"rfft"``),
  :func:`dft_matrices`;
- mel scales: :func:`hz_to_mel`, :func:`mel_to_hz`, :func:`mel_filterbank`,
  :func:`power_to_db`, :func:`normalize_log_mel`;
- the log-mel frontends: :class:`LogMelFrontend` (librosa and torchaudio
  styles), :func:`log_mel_spectrogram`, :func:`mel_with_temporal_detail`;
- eGeMAPS: ``EGEMAPS_FEATURE_NAMES``, :class:`EgemapsConfig`,
  :class:`LldCarry`, :func:`compute_llds`, :func:`compute_lld_block`,
  :func:`silence_lld_carry`, :func:`functionals_from_llds`,
  :func:`functionals_multi_offset`, :func:`egemaps_functionals`,
  :func:`egemaps_concat_windows`, :func:`load_calibration`,
  :func:`apply_calibration`;
- F0: :class:`F0Result`, :func:`yin_f0`;
- reconstruction: :func:`griffin_lim`, :func:`mel_to_linear`,
  :func:`reconstruct_audio`, :func:`compute_reconstruction_snr`,
  :func:`validate_mel_parameters`.

Prosody lives in :mod:`koemorph_tpu_torch.ops.prosody`, as in the JAX
package. Importing this package registers the kernels' ``torch.library``
operators (:mod:`koemorph_tpu_torch.ops.library`), which exported
programs hold.
"""

from koemorph_tpu_torch.ops.window import frame_signal, hann_window, num_frames
from koemorph_tpu_torch.ops.stft import dft_matrices, stft_power
from koemorph_tpu_torch.ops.mel import (hz_to_mel, mel_filterbank,
                                        mel_to_hz, normalize_log_mel,
                                        power_to_db)
from koemorph_tpu_torch.ops.frontend import (LogMelFrontend,
                                             log_mel_spectrogram,
                                             mel_with_temporal_detail)
from koemorph_tpu_torch.ops.egemaps import (
    FEATURE_NAMES as EGEMAPS_FEATURE_NAMES,
    EgemapsConfig,
    LldCarry,
    apply_calibration,
    compute_lld_block,
    compute_llds,
    egemaps_concat_windows,
    egemaps_functionals,
    functionals_from_llds,
    functionals_multi_offset,
    load_calibration,
    silence_lld_carry,
)
from koemorph_tpu_torch.ops.f0 import F0Result, yin_f0
from koemorph_tpu_torch.ops.reconstruct import (compute_reconstruction_snr,
                                                griffin_lim, mel_to_linear,
                                                reconstruct_audio,
                                                validate_mel_parameters)
from koemorph_tpu_torch.ops import library  # noqa: F401  (registers ops)

__all__ = [
    "frame_signal",
    "hann_window",
    "num_frames",
    "stft_power",
    "dft_matrices",
    "hz_to_mel",
    "mel_to_hz",
    "mel_filterbank",
    "power_to_db",
    "normalize_log_mel",
    "LogMelFrontend",
    "log_mel_spectrogram",
    "mel_with_temporal_detail",
    "griffin_lim",
    "mel_to_linear",
    "reconstruct_audio",
    "compute_reconstruction_snr",
    "validate_mel_parameters",
    "EGEMAPS_FEATURE_NAMES",
    "EgemapsConfig",
    "LldCarry",
    "apply_calibration",
    "compute_lld_block",
    "compute_llds",
    "egemaps_concat_windows",
    "egemaps_functionals",
    "functionals_from_llds",
    "functionals_multi_offset",
    "load_calibration",
    "silence_lld_carry",
    "F0Result",
    "yin_f0",
]
