"""Waveform models of the fit."""
