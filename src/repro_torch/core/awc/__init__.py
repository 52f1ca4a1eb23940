"""Adaptive Window Control (paper §4): WC-DNN deployment + stabilization."""

from . import model
from .stabilize import StabilizerConfig, WindowStabilizer
from .model import (WCDNNParams, bootstrap_gamma, default_predictor, load,
                    numpy_predictor)
