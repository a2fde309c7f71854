"""Signal processing: windows (``window``), STFT (``stft``), mel filterbanks
the log-mel frontends (``mel``), the CWT f0 recomposition (``f0``) and the
host-side DTW metric (``dtw``)."""
