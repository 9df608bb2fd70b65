"""Calibration constants (counterpart of the JAX package's
models/calibration.py).  The chirp calibration subsystem itself comes with
the parity slice; ``localize_sound_source`` already applies given
calibration delays behind this quality gate.
"""

# Correlation-peak SNR below which a calibration is noise, not signal: a
# matched chirp peak measures ~175 on this statistic even at unity
# signal/noise, while the max-of-noise artifact of a signal-free recording
# measures ~7 (sqrt(2 ln 2N) scaling).
CALIBRATION_SNR_GATE = 20.0
