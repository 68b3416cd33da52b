"""Gaussian-product primitives.

The analytic heart of the method: the integral over a true position of
(localization error) x (diffusion step) x (running prior) is a constant times
a Gaussian (reference: extrack/tracking.py:76-107).  All functions work in
log space on tensors of any leading shape, the spatial dimension last, on
the device and in the dtype of their inputs.  Plain torch: the JAX package
computes them in XLA (extrack_tpu/core/gaussian.py).
"""
from __future__ import annotations

import torch

_LOG_2PI = 1.8378770664093453


def first_convolve(x0, l2_0, sig2_0):
    """Observation of the first position under a flat prior on r_0.

    r_1 | x_0 ~ N(x_0, l2_0 + sig2_0)   (per spatial dim).
    Reference: first_log_integrale_dif, extrack/tracking.py:101-107.
    """
    return x0, l2_0 + sig2_0


def propagate(x, l2, sig2, m, s2):
    """One marginalization step.

    Integrates r_t out of N(x; r_t, l2) * N(r_{t+1}-r_t; 0, sig2) *
    N(r_t; m, s2), yielding ``const * N(r_{t+1}; new_m, new_s2)``.

    Returns (new_m, new_s2, log_const) where log_const is summed over the
    trailing spatial axis.  Reference: log_integrale_dif,
    extrack/tracking.py:76-98.
    """
    tot = l2 + s2
    new_m = (m * l2 + x * s2) / tot
    new_s2 = sig2 + l2 * s2 / tot
    log_c = torch.sum(-0.5 * (torch.log(tot) + _LOG_2PI)
                      - (x - m) ** 2 / (2.0 * tot), dim=-1)
    return new_m, new_s2, log_c


def final_integral(x, l2, m, s2):
    """Log of the final observation integral: sum_d log N(x; m, s2 + l2).

    Reference: the closing ``log_integrated_term``
    (extrack/tracking.py:634-635).
    """
    tot = l2 + s2
    return torch.sum(-0.5 * (torch.log(tot) + _LOG_2PI)
                     - (x - m) ** 2 / (2.0 * tot), dim=-1)


def product_2(sigma1, sigma2, mu1, mu2):
    """Product of two Gaussian PDFs -> (sigma, mu, log_const).

    log_const is summed over the trailing spatial axis.
    Reference: prod_2GaussPDF, extrack/refined_localization.py:33-37.
    """
    v1, v2 = sigma1 ** 2, sigma2 ** 2
    tot = v1 + v2
    sigma = torch.sqrt(v1 * v2 / tot)
    mu = (mu1 * v2 + mu2 * v1) / tot
    log_c = torch.sum(-0.5 * (torch.log(tot) + _LOG_2PI)
                      - (mu1 - mu2) ** 2 / (2.0 * tot), dim=-1)
    return sigma, mu, log_c


def product_3(sigma1, sigma2, sigma3, mu1, mu2, mu3):
    """Product of three Gaussian PDFs.
    Reference: prod_3GaussPDF, extrack/refined_localization.py:39-43."""
    sigma, mu, log_c = product_2(sigma1, sigma2, mu1, mu2)
    sigma, mu, log_c2 = product_2(sigma, sigma3, mu, mu3)
    return sigma, mu, log_c + log_c2
