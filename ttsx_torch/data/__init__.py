"""Data path of the trainer: wav tree -> dataset items -> collated batches
(mel through K3, f0/energy) -> per-stage trainer batches; the speaker
and prosody datasets and the synthetic tone corpus."""
