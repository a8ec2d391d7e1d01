"""The port's data layer, copies of vqa_tpu.datasets: data prep (raw VQA json
-> interim -> processed npz), the feature store, the dataset, the batching
pipeline and the factory that prepares on first use; yaml and h5py are
imported only where a file is read or written."""
