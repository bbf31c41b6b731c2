"""The tiny multitask configuration and corpus that the card test
(tests/test_torch_gpu.py) and the CPU order tests
(tests/test_torch_mt_order.py) share, so the two cannot drift apart, and
the epoch recorder that the card test and ``chip_smoke.py
--mt-epoch-spread`` share. Imports neither torch nor JAX at import time.

One loader worker: ``PrefetchLoader``'s workers each draw from their own
seed and feed one queue in finishing order, so over two workers two runs
of one config train on different batches in a different order."""

MT_TINY = dict(seed=0, tdnn_layer_size=16, num_nodes_pooling_layer=24, speaker_dim=16,
               phone_dim=12, embedding_node="zs_mu_dense", spk_loss_type="softmax",
               phn_loss_type="softmax", phn_loss_weight=0.2, num_shared_layers=2,
               phone_kernel_size=[5, 5, 7, 1, 3], phone_layer_size=[16] * 5,
               phone_dilation_size=[1, 1, 1, 1, 4], phone_left_context=11,
               phone_right_context=11, num_frames_per_utt=5, learning_rate=0.05,
               optimizer="momentum", momentum=0.9, weight_l2_regularizer=1e-4,
               num_steps_per_epoch=4, steps_per_dispatch=2,
               num_parallel_datasets=1,  # two workers feed one queue in finishing order
               num_speakers_per_batch=4, min_segment_len=64, max_segment_len=96,
               valid_max_iterations=2, show_training_progress=2)

# make_fake_data_dir's arguments for the corpus both tests train on
MT_CORPUS = dict(num_speakers=5, utts_per_speaker=4, dim=20, min_len=120, max_len=200,
                 with_vad_ali=True, num_phones=7)

# the card test's tolerance for the variables after a step, card against CPU
MT_EPOCH_TOL = dict(rtol=2e-4, atol=5e-5)


def _host_copy(tree):
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host_copy(v) for v in tree]
    return tree.detach().to("cpu", copy=True) if hasattr(tree, "detach") else tree


def train_epoch(trainer, data, starts_from=None):
    """One epoch of a built ``TrainerMultiTask`` (``trainer.train`` over
    ``data``: data dir, alignment dir, spklist) that records, for each
    step, the state it started from (variables and optimizer state) and
    the variables after it. With ``starts_from`` (another run's recorded
    start states), each step first loads the state that the other run's
    step started from: the two runs then go in lockstep, and each step
    compares as one step from one state. Returns (each step's weighted
    loss, the start states, the variables after each step, flattened)."""
    from tf_kaldi_speaker_tpu_torch.convert import flatten, load_variables, variables_of

    cfg, model = trainer.params.dict, trainer.network_model
    losses, starts, after = [], [], []
    step = trainer.train_step

    def recording(*args):
        if starts_from is not None:
            variables, opt_state = starts_from[len(starts)]
            load_variables(model, variables)
            trainer.optimizer.load_state(opt_state)
        starts.append((_host_copy(variables_of(model)), _host_copy(trainer.optimizer.state())))
        m = step(*args)
        losses.append(float(cfg.get("spk_loss_weight", 1.0)) * float(m["spk_loss"])
                      + float(cfg["phn_loss_weight"]) * float(m["phn_loss"]))
        after.append(flatten(_host_copy(variables_of(model))))
        return m

    trainer.train_step = recording
    try:
        trainer.train(*data, float(cfg["learning_rate"]))
    finally:
        del trainer.train_step
    return losses, starts, after
