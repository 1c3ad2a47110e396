"""The port's CLI, with the flags and defaults of the repository's main.py
(the reference's public flag surface, reference main.py:181-222):

    python -m efficientconformer_torch.main -c configs/EfficientConformerCTCSmall.json \\
        -m training [--create_tokenizer] [-p] [--cpu] ...

Modes: training, training-clean, validation-{clean,other},
test-{clean,other}, eval_time, eval_time_encoder, eval_time_decoder, and
--swa (runtime.py); validation and test decode with the config's beam
search unless --gready asks for greedy decoding, and --initial_epoch_lm
fuses the config's LM into the Transducer beam. It runs on the GPU, and
raises without one unless --cpu asks for the CPU. The flags whose work the port does not have raise
NotImplementedError naming their ROADMAP item.
"""

import argparse
import sys


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("-c", "--config_file", type=str,
                   default="configs/EfficientConformerCTCSmall.json",
                   help="Json configuration file containing model hyperparameters")
    p.add_argument("-m", "--mode", type=str, default="training",
                   help="Mode : training, validation-clean, test-clean, eval_time-dev-clean, ...")
    p.add_argument("-d", "--distributed", action="store_true",
                   help="Distributed data parallelism (not ported: ROADMAP item 14)")
    p.add_argument("-i", "--initial_epoch", type=str, default=None,
                   help="Load model from checkpoint")
    p.add_argument("--initial_epoch_lm", type=str, default=None,
                   help="Load language model from checkpoint")
    p.add_argument("--initial_epoch_encoder", type=str, default=None,
                   help="Load model encoder from encoder checkpoint")
    p.add_argument("-p", "--prepare_dataset", action="store_true",
                   help="Prepare dataset for training")
    p.add_argument("-j", "--num_workers", type=int, default=8,
                   help="Number of data loading workers")
    p.add_argument("--create_tokenizer", action="store_true",
                   help="Create model tokenizer")
    p.add_argument("--batch_size_eval", type=int, default=8,
                   help="Evaluation batch size")
    p.add_argument("--verbose_val", action="store_true", help="Evaluation verbose")
    p.add_argument("--val_steps", type=int, default=None,
                   help="Number of validation steps")
    p.add_argument("--steps_per_epoch", type=int, default=None,
                   help="Number of steps per epoch")
    p.add_argument("--world_size", type=int, default=None,
                   help="Number of GPUs (more than one not ported: ROADMAP item 14)")
    p.add_argument("--cpu", action="store_true",
                   help="Run on cpu (the default is the GPU; without one the CLI raises)")
    p.add_argument("--show_dict", action="store_true", help="Show model dict summary")
    p.add_argument("--swa", action="store_true", help="Stochastic weight averaging")
    p.add_argument("--swa_epochs", nargs="+", default=None,
                   help="Start epoch / end epoch for swa")
    p.add_argument("--swa_epochs_list", nargs="+", default=None,
                   help="List of checkpoints epochs for swa")
    p.add_argument("--swa_type", type=str, default="equal",
                   help="Stochastic weight averaging type (equal/exp)")
    p.add_argument("--parallel", action="store_true",
                   help="Data parallelism (not ported: ROADMAP item 14)")
    p.add_argument("--rnnt_max_consec_dec_steps", type=int, default=None,
                   help="Number of maximum consecutive transducer decoder steps during inference")
    p.add_argument("--eval_loss", action="store_true",
                   help="Compute evaluation loss during evaluation")
    p.add_argument("--gready", action="store_true",
                   help="Proceed to a gready search evaluation")
    p.add_argument("--saving_period", type=int, default=1,
                   help="Model saving every 'n' epochs")
    p.add_argument("--val_period", type=int, default=1,
                   help="Model validation every 'n' epochs")
    p.add_argument("--profiler", action="store_true",
                   help="Profile the eval_time modes: a trace and a top-10 op table")
    p.add_argument("--model_parallel", type=int, default=None,
                   help="Tensor-parallel size (not ported: ROADMAP item 14)")
    p.add_argument("--seq_parallel", type=int, default=None,
                   help="Sequence-parallel size (not ported: ROADMAP item 14)")
    return p


def main(args=None):
    from efficientconformer_torch import runtime

    return runtime.run(build_parser().parse_args(args))


if __name__ == "__main__":
    sys.exit(main())
