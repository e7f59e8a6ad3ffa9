"""Training entry point of the port.

    # the shipped V2A + V2P model (crossatt3) on the card
    python -m v2ap_torch.train --corpora-root /data/scps --steps 100000

    # 88 keys, accumulated batches
    python -m v2ap_torch.train --corpora-root /data/scps \\
        --variant crossatt3_2 --grad-accum 2 --batch-size 16

    # everything from a config file (V2APConfig JSON, either package's)
    python -m v2ap_torch.train --corpora-root /data/scps --config cfg.json

    # preference optimization on <root>/pairs.scp (a*/b* winner / loser
    # files) and FactorCL, the variant-6 model
    python -m v2ap_torch.train --corpora-root /data/scps --dpo \
        --variant crossatt6

    # the CPU-runnable miniature
    python -m v2ap_torch.train --corpora-root /tmp/c --tiny --device cpu

Counterpart of ``scripts/train.py``: the corpus mix
(``manifests.default_corpora`` under ``--corpora-root``, and with ``--dpo``
the preference-pair corpus ``<root>/pairs.scp``), the host ``TrainBatcher``
(with ``--dpo`` every micro-batch ends with a pair) and the
``TrainingPipeline``, which resumes from and checkpoints to
``--work-dir/ckpts``. Remat is on with the ``dots`` policy unless
``--no-remat`` or ``--tiny``, as in JAX. ``--video-encoder`` picks the
video tower(s) (``mixed``: the four concatenated, 4608-d through the CFM's
``proj_text``).

Several processes, one per card (``torchrun``):

    torchrun --nproc-per-node 8 -m v2ap_torch.train --corpora-root /data/scps

``init_distributed`` forms the process group first (a single process
forms none), and with more than one rank the ``MeshConfig`` of the config
(``--config``'s ``mesh`` section; by default every rank data-parallel)
becomes the mesh the CFM trains on, unless ``--no-mesh``. ``--host-id`` /
``--num-hosts`` stride the video and pair corpora per rank in
``TrainBatcher``; they default to ``host_shard_info()`` (rank, world size)
without a mesh and to the rank's data index and the data axis's size with
one (the ranks of a model group train on the same rows). Metrics are
averaged over the ranks (``all_hosts_mean``) and written by rank 0.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys


def build_config(args):
    from v2ap_torch import config as cfgmod

    if args.config:
        with open(args.config) as f:
            cfg = cfgmod.V2APConfig.from_json(f.read())
    elif args.tiny:
        cfg = cfgmod.tiny_tower_test()
        base = cfgmod.variant_preset(args.variant)
        cfg = cfg.replace(
            model=dataclasses.replace(cfg.model,
                                      video2roll=base.model.video2roll),
            train=dataclasses.replace(cfg.train,
                                      contrastive=base.train.contrastive))
    else:
        cfg = cfgmod.variant_preset(args.variant)

    model_kw, train_kw, cond_kw = {}, {}, {}
    if not args.no_remat and not args.tiny:
        model_kw.update(remat=True, remat_policy=args.remat_policy)
    if args.video_encoder:
        cond_kw["video_encoder"] = args.video_encoder
        if args.video_encoder == "mixed":
            model_kw["dim_text_raw"] = 4608
    if args.dpo:
        train_kw["dpo"] = True
    if args.contrastive:
        train_kw["contrastive"] = True
    if args.grad_accum is not None:
        train_kw["grad_accum"] = args.grad_accum
    if args.batch_size is not None:
        train_kw["batch_size"] = args.batch_size
    if model_kw:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, **model_kw))
    if train_kw:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, **train_kw))
    if cond_kw:
        cfg = cfg.replace(conditioning=dataclasses.replace(cfg.conditioning,
                                                           **cond_kw))
    return cfg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m v2ap_torch.train")
    ap.add_argument("--corpora-root", required=True)
    ap.add_argument("--config", default=None,
                    help="V2APConfig JSON file (V2APConfig.to_json); the "
                         "flags below override its values")
    ap.add_argument("--variant", default="crossatt3",
                    help="crossatt (no piano-roll stream), crossatt6 (with "
                         "FactorCL), crossatt3 (the shipped V2A + V2P "
                         "model) or crossatt3_2 (88 keys)")
    ap.add_argument("--video-encoder", default=None,
                    choices=("clip_vit", "clip_vit2", "clip_convnext",
                             "dinov2", "mixed"))
    ap.add_argument("--dpo", action="store_true",
                    help="preference optimization: <corpora-root>/pairs.scp "
                         "lists a*/b* winner / loser files of one clip")
    ap.add_argument("--contrastive", action="store_true",
                    help="the FactorCL audio <-> video contrastive loss")
    ap.add_argument("--grad-accum", type=int, default=None)
    ap.add_argument("--steps", type=int, default=100_000)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--eval-scp", default=None,
                    help="held-out manifest for the val loss / F1 and the "
                         "latent figures every save_step")
    ap.add_argument("--work-dir", default="runs/v2ap")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--remat-policy", choices=("dots", "full"),
                    default="dots",
                    help="'dots' keeps the products' outputs (faster), "
                         "'full' recomputes everything (least memory)")
    ap.add_argument("--no-remat", action="store_true",
                    help="keep all activations")
    ap.add_argument("--tiny", action="store_true",
                    help="the miniature model and frozen towers")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--host-id", type=int, default=None,
                    help="this process's index: the video and pair corpora "
                         "are strided per host (default: from the process "
                         "group, see above)")
    ap.add_argument("--num-hosts", type=int, default=None,
                    help="processes sharing the corpora")
    ap.add_argument("--no-mesh", action="store_true",
                    help="build no mesh over several ranks (single-device "
                         "debugging)")
    args = ap.parse_args(argv)

    from v2ap_torch.parallel.distributed import (host_shard_info,
                                                 init_distributed)
    init_distributed(device=args.device)

    from v2ap_torch.data.dataset import TrainBatcher
    from v2ap_torch.data.manifests import (CorpusSpec, default_corpora,
                                           load_corpora, load_corpus)
    from v2ap_torch.training.pipeline import TrainingPipeline

    cfg = build_config(args)
    host_id, num_hosts = host_shard_info()
    mesh = None
    if not args.no_mesh and num_hosts > 1:
        from v2ap_torch.parallel import make_mesh
        from v2ap_torch.parallel.mesh import mesh_axes

        mesh = make_mesh(cfg.mesh)
        _, num_hosts, host_id, *_ = mesh_axes(mesh)
    if args.host_id is not None:
        host_id = args.host_id
    if args.num_hosts is not None:
        num_hosts = args.num_hosts
    specs = default_corpora(args.corpora_root)
    if cfg.train.dpo:
        # the preference pairs: a*/b* files of one clip (winner / loser)
        specs.append(CorpusSpec("preference_pairs",
                                os.path.join(args.corpora_root, "pairs.scp"),
                                is_video=True, preference_pairs=True))
    samples = load_corpora(specs)
    if not samples:
        print(f"no samples found under {args.corpora_root}", file=sys.stderr)
        return 2
    batcher = TrainBatcher(samples, cfg.data,
                           batch_size=cfg.train.batch_size,
                           host_id=host_id, num_hosts=num_hosts,
                           seed=args.seed, dpo=cfg.train.dpo,
                           micro_batches=cfg.train.grad_accum)
    eval_batcher = None
    if args.eval_scp:
        eval_samples = load_corpus(CorpusSpec("eval", args.eval_scp))
        if eval_samples:
            eval_batcher = TrainBatcher(eval_samples, cfg.data,
                                        batch_size=cfg.train.batch_size,
                                        seed=args.seed + 1, mix_prob=0.0)
    tower_kw = {}
    if args.tiny:
        from v2ap_torch.models.clip_vit import clip_tiny_test
        from v2ap_torch.models.t5 import t5_tiny_test
        tower_kw = dict(t5_config=t5_tiny_test(), clip_config=clip_tiny_test())
    pipeline = TrainingPipeline(cfg, seed=args.seed, work_dir=args.work_dir,
                                device=args.device, mesh=mesh, **tower_kw)
    final = pipeline.fit(batcher, num_steps=args.steps,
                         eval_batcher=eval_batcher, seed=args.seed)
    print(f"finished at step {final}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
