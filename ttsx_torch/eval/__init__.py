"""Evaluation metrics of the port (``ttsx/eval``): the EER and the
diarizer's DER, purity and silhouette."""
