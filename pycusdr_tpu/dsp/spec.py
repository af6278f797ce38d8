"""Static per-channel demodulator specification.

Everything the block-processing graph needs that is known at init time
(FFT length, filter bank, Doppler grid, timing-search band, LUTs) is
resolved here once, mirroring what the reference computes in
``Demodulator.__init__`` (``demodulator/demodulator_base.py:75-243``,
Doppler grid ``:129-167``, timing band ``:508-512``). The jitted graph
closes over these as device constants, so XLA sees fully static shapes.
"""

from dataclasses import dataclass
from typing import Optional

import numpy as np
import scipy.constants


@dataclass(frozen=True)
class DemodSpec:
    radioName: str
    Nfft: int
    sigOverlap: int  # samples of overlap-save history
    spsym: float  # nominal samples/symbol
    baudRate: float
    num_masks: int
    masks_f: np.ndarray  # (M, Nfft) complex64, conj FFT'd filter bank
    windowWidth: int  # symbol-centre search window (odd)

    # Doppler search grid
    num_dopplers: int
    dopp_shifts: np.ndarray  # (D,) int32 FFT-bin shifts (noise bin first if present)
    dopp_hz_lut: np.ndarray  # (D,) Hz per grid entry
    dopp_array_offset: int  # = D - num_dopplers (1 when a noise bin is prepended)
    sum_all_masks: bool
    doppler_search: bool  # False => fixed offset (STX mode)
    dopp_offset_idx: int  # fixed shift used when doppler_search is False

    # input spike clipping
    peak_threshold_scale: float
    clipped_peak_span: int
    disable_peak_thresholding: bool

    # symbol timing search band (FFT bin indices into rfft(power))
    code_search_mask_offset: int = 0

    # symbol->bit mapping
    bitLUT: Optional[np.ndarray] = None  # (M,) centre bits, or None for NRZ-S
    symbolLUT: Optional[np.ndarray] = None  # 3-D NRZ-S transition LUT

    # misc
    centreFreqOffset: float = 0.0
    voteWeight: int = 1
    snr_window: int = 5
    # operand dtype for the Doppler contraction: None/"float32" or
    # "bfloat16" (f32 accumulation; BER-delta-gated, see
    # ops/doppler_search.py)
    matmul_dtype: Optional[str] = None

    # derived (filled by build_spec)
    spsymMin: int = 0
    numSymMax: int = 0
    code_idx_lo: int = 0  # inclusive rfft-bin band start  (Nfft/(1.1*spsym))
    code_idx_hi: int = 0  # exclusive band end            (Nfft/(0.9*spsym))
    sampleRate: float = 0.0

    @property
    def windowLeft(self) -> int:
        return self.windowWidth // 2

    @property
    def D(self) -> int:
        return len(self.dopp_shifts)


def build_doppler_grid(
    Nfft: int,
    num_dopplers: int,
    baud: float,
    spsym: float,
    frequency_Hz: float,
    frequencyOffset_Hz: float,
    rangeRateMax: float,
    noise_measure_offset_Hz=False,
):
    """Doppler search grid in normalized frequency and FFT-bin shifts.

    Mirrors reference ``demodulator_base.py:129-167``: the IF offset
    centres the grid, rangeRateMax sets its half width, and an optional
    off-tuned noise-measurement bin is prepended.
    """
    sampleRate = baud * spsym
    doppOffset = frequencyOffset_Hz / baud / spsym
    Fc_IF = frequency_Hz - frequencyOffset_Hz

    doppMax = rangeRateMax * Fc_IF / scipy.constants.speed_of_light
    doppMaxNorm = doppMax / sampleRate
    lo = doppOffset - doppMaxNorm
    hi = doppOffset + doppMaxNorm

    grid = np.linspace(lo, hi, num_dopplers)
    if noise_measure_offset_Hz:
        noise_norm = noise_measure_offset_Hz / baud / spsym
        grid = np.concatenate(([noise_norm], grid))

    hz_lut = grid * spsym * baud
    shifts = np.round(grid * Nfft).astype(np.int32)
    shifts[shifts < 0] += Nfft

    dopp_offset_idx = np.int32(round(doppOffset * Nfft))
    if dopp_offset_idx < 0:
        dopp_offset_idx += Nfft

    return shifts, hz_lut, int(dopp_offset_idx), sampleRate


def narrow_spec(spec: DemodSpec, track_bins: int, span_bins: int) -> DemodSpec:
    """A tracking variant of ``spec``: ``track_bins`` Doppler bins over
    ±``span_bins``/2 FFT bins around the IF offset. Combined with the
    runtime ``centre_shift`` of the block graph this gives the
    search-and-track loop its narrow follow grid (models/tracking.py).
    """
    import dataclasses

    N = spec.Nfft
    raw = np.round(
        spec.dopp_offset_idx + np.linspace(-span_bins / 2, span_bins / 2, track_bins)
    ).astype(np.int64)
    hz_lut = (raw * spec.sampleRate / N).astype(np.float64)
    shifts = np.mod(raw, N).astype(np.int32)
    return dataclasses.replace(
        spec,
        num_dopplers=track_bins,
        dopp_shifts=shifts,
        dopp_hz_lut=hz_lut,
        dopp_array_offset=0,
    )


def build_spec(conf: dict, protocol, radioName: str) -> DemodSpec:
    """Resolve config + protocol into a frozen DemodSpec."""
    confRadio = conf["Radios"]["Rx"][radioName]
    confGPU = conf["GPU"][confRadio["CUDA_settings"]]

    Nfft = 2 ** confGPU["blockSize"]
    sigOverlap = 2 ** confGPU["overlap"]
    spsym = float(confRadio["samplesPerSym"])
    baud = float(confRadio["baud"])
    num_dopplers = int(confRadio.get("doppCarrierSteps", confGPU.get("doppCarrierSteps", 64)))

    maskSize = confGPU["xcorrMaskSize"]
    num_masks, masks_f = protocol.get_filter(Nfft, int(spsym), maskSize)
    bitLUT, symbolLUT = protocol.get_symbolLUT2(maskSize)

    shifts, hz_lut, dopp_offset_idx, sampleRate = build_doppler_grid(
        Nfft,
        num_dopplers,
        baud,
        spsym,
        confRadio["frequency_Hz"],
        confRadio["frequencyOffset_Hz"],
        conf["Radios"].get("rangeRateMax", 27500),
        confRadio.get("noise_measure_offset_Hz", False),
    )

    spsymMin = int(spsym / 2)
    backend = confRadio.get("radioBackend", "UHF")

    # Static slot-count bound: spSym always comes from the timing band
    # (find_code_rate_and_phase restricts its argmax to
    # [Nfft/(1.1·spsym), Nfft/(0.9·spsym))), so spc = max(Nfft/k,
    # spsymMin) = Nfft/k with k < code_idx_hi — the spsymMin clamp can
    # never bind inside the band (Nfft/code_idx_hi ≈ 0.9·spsym >
    # spsymMin = spsym/2) — and nSym = Nfft/spc ≤ k ≤ code_idx_hi − 1.
    # The reference allocates the looser Nfft/spsymMin
    # (demodulator_base.py:468-473); the tight bound cuts ~44% of the
    # symbol-detection and bit-extraction work at the flagship shape.
    code_idx_hi = int(Nfft / (0.9 * spsym))
    num_sym_max = min(int(Nfft / spsymMin), -(-code_idx_hi // 128) * 128)

    spec = DemodSpec(
        radioName=radioName,
        Nfft=Nfft,
        sigOverlap=sigOverlap,
        spsym=spsym,
        baudRate=baud,
        num_masks=num_masks,
        masks_f=np.asarray(masks_f, dtype=np.complex64),
        windowWidth=int(confGPU["bitWindowWidth"]),
        num_dopplers=num_dopplers,
        dopp_shifts=shifts,
        dopp_hz_lut=hz_lut,
        dopp_array_offset=len(shifts) - num_dopplers,
        sum_all_masks=bool(getattr(protocol, "SUM_ALL_MASKS_PYTHON", False)),
        doppler_search=(backend == "UHF"),
        dopp_offset_idx=dopp_offset_idx,
        peak_threshold_scale=float(confGPU.get("peakThresholdScale", 40.5)),
        clipped_peak_span=int(confGPU.get("clippedPeakSpan", 20)),
        disable_peak_thresholding=bool(confRadio.get("disablePeakThresholding", backend == "UHF")),
        bitLUT=None if bitLUT is None else np.asarray(bitLUT),
        symbolLUT=None if symbolLUT is None or (isinstance(symbolLUT, (list, tuple)) and not len(symbolLUT)) else np.asarray(symbolLUT),
        centreFreqOffset=float(confRadio["frequencyOffset_Hz"]),
        voteWeight=int(confRadio.get("voteWeight", 1)),
        spsymMin=spsymMin,
        numSymMax=num_sym_max,
        code_idx_lo=int(Nfft / (1.1 * spsym)),
        code_idx_hi=code_idx_hi,
        sampleRate=sampleRate,
        matmul_dtype=confGPU.get("matmulDtype"),
    )
    return spec
