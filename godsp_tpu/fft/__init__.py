"""L1 transforms: FFT/IFFT (1-D/2-D/N-D, real/complex), convolution.

Counterpart of the reference fft package (go-dsp fft/).  Power-of-2
sizes take the four-step matmul formulation (four_step.py, dispatched by
pow2.py); other sizes take Bluestein chirp-z (bluestein.py).  The
Stockham radix-2 kernel (stockham.py) stays as an independent oracle.
"""

from godsp_tpu.fft.bluestein import bluestein_fft
from godsp_tpu.fft.fftlog import fht, fhtoffset, ifht
from godsp_tpu.fft._czt_impl import CZT, ZoomFFT, czt, czt_points, zoom_fft
from godsp_tpu.fft._dct_impl import dct, dctn, dst, dstn, idct, idctn, idst, idstn
from godsp_tpu.fft.core import (
    convolve,
    ensure_radix2_factors,
    fft,
    fft2,
    fft2_real,
    fft_real,
    fftn,
    ifft,
    ifft2,
    ifft2_real,
    ifft_real,
    ifftn,
)
from godsp_tpu.fft.four_step import four_step_fft
from godsp_tpu.fft.helpers import fftfreq, fftshift, hilbert, ifftshift, rfftfreq, hfft, hfft2, hfftn, ihfft, ihfft2, ihfftn, irfft, irfft2, irfftn, next_fast_len, prev_fast_len, rfft, rfft2, rfftn
from godsp_tpu.fft.pow2 import pow2_fft
from godsp_tpu.fft.split import fft_split, ifft_split, rfft_split
from godsp_tpu.fft.stockham import stockham_fft, twiddles

__all__ = [
    "bluestein_fft",
    "convolve",
    "CZT",
    "ZoomFFT",
    "czt",
    "czt_points",
    "dct",
    "dctn",
    "dst",
    "dstn",
    "idct",
    "idctn",
    "idst",
    "idstn",
    "ensure_radix2_factors",
    "fft",
    "four_step_fft",
    "fft2",
    "fft2_real",
    "fft_real",
    "fht",
    "fhtoffset",
    "fft_split",
    "rfft_split",
    "ifft_split",
    "fftfreq",
    "fftn",
    "fftshift",
    "hfft",
    "hfft2",
    "hfftn",
    "hilbert",
    "ihfft",
    "ihfft2",
    "ihfftn",
    "irfft",
    "irfft2",
    "irfftn",
    "next_fast_len",
    "prev_fast_len",
    "rfft",
    "rfft2",
    "rfftn",
    "ifft",
    "ifftshift",
    "rfftfreq",
    "ifft2",
    "ifft2_real",
    "ifft_real",
    "ifht",
    "ifftn",
    "pow2_fft",
    "stockham_fft",
    "twiddles",
    "zoom_fft",
]
