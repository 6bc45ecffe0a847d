"""Data path of the trainer: wav tree -> dataset items -> collated batches
(mel through K3, f0/energy) -> per-stage trainer batches; the speaker
and prosody datasets, the speaker encoder's manifests and prefetching
wav loader, and the synthetic tone and formant corpora."""
from ttsx_torch.data.dataset import (
    TTSDataset, TTSDatasetConfig, PhonemeFrontend, TextEncoder,
    SpeakerBalancedSampler, load_file_list, read_wav, write_wav)
from ttsx_torch.data.collate import (
    TTSCollator, CollatorConfig, AugmentationPipeline, add_noise,
    add_reverb, speed_perturb, spec_augment, mixup, bucket_length,
    load_noise_bank)
from ttsx_torch.data.synthetic import synthetic_batch, synthetic_stream
from ttsx_torch.data.refenc_dataset import (RefEncDataset,
                                            ProsodyManifestDataset)
from ttsx_torch.data.adapters import collator_to_trainer_batch
from ttsx_torch.data.prefetch import WavBatchLoader
