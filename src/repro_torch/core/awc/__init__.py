"""Adaptive Window Control (paper §4): WC-DNN deployment + stabilization."""

from . import model
from .stabilize import StabilizerConfig, WindowStabilizer
from .model import (WCDNNParams, bootstrap_gamma, default_predictor, forward,
                    init, load, numpy_predictor, save, set_normalization)
