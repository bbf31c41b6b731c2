"""Training-quality harnesses of the port: the entry points that show that
training through the port *learns*, each a copy of a validation script of
the JAX side (``scripts/``) over the port's trainer, extractor, back end
and Kaldi codec. Run each as ``python -m
tf_kaldi_speaker_tpu_torch.validation.<name>`` (``--device cuda`` by
default; no CPU fallback):

- :mod:`.corpora`: the synthetic corpora (the hard 600-speaker corpus and
  the 200-speaker convergence corpus), byte-equal to the scripts' for the
  same seeds;
- :mod:`.common`: the held-out EER protocol, the oracle EER, the exact rank
  test and the 3-sigma band rule;
- :mod:`.quality_matrix`, :mod:`.qmatrix_extra`, :mod:`.synthetic`: the
  hard-corpus quality matrix and its follow-ups, the legacy separable run;
- :mod:`.convergence`: the 512-wide head-to-head convergence matrix (the
  framework arm; the TF1 reference arm is not ported), judged against the
  JAX rows on the record;
- :mod:`.attention`, :mod:`.ecapa`, :mod:`.resnet`, :mod:`.multitask`: the
  model-family validations;
- :mod:`.decoder_stress`: the WFST decoder at a realistic graph size (host
  code).
"""
