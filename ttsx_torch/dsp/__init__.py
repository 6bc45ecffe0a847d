"""Signal processing of the port: STFT / mel frontend and f0 / energy."""
