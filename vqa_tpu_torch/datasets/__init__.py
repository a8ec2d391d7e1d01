"""The port's data layer: copies of the serving-side text encoding and of the
read side of vqa_tpu.datasets (vocabularies, the feature table); yaml and
h5py are imported only where a file is read. Data prep is not ported."""
