"""Spectral front ends of the port: STFT and log-mel."""
