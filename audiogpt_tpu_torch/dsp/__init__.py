"""Signal processing: windows (``window``), STFT (``stft``), mel filterbanks
and the log-mel frontends (``mel``)."""
