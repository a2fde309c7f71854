"""Signal processing: windows (``window``), STFT (``stft``), mel filterbanks
the log-mel frontends (``mel``) and the CWT f0 recomposition (``f0``)."""
