"""The four synthesis models and the pipeline that chains them."""
