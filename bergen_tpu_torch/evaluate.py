"""Post-hoc LLM-judge / LID evaluation CLI of the PyTorch port (the
counterpart of the root ``evaluate.py``).

Scans experiment folders, computes LLMeval (logits or text mode, optionally
pairwise against an opponent folder) and LID metrics over the stored
``eval_{split}_out.json``, appends per-sample columns, and updates
``eval_{split}_metrics.json`` atomically.  Idempotent: already-computed metrics
are skipped unless --force.  The judge runs on ``--device`` (default
``cuda``); its generator config is read from the repository's
``config/generator`` (``run_eval(generator_config_dir=...)`` reads another
folder), the judge prompts from ``config/evaluator``.

    python -m bergen_tpu_torch.evaluate --experiments_folder experiments/ \\
        --llm tinyllama-chat tiny [--device cpu]
    python -m bergen_tpu_torch.evaluate --folder experiments/<run> --lid

A judge whose generator config sets ``tp`` > 1 (the default, SOLAR-107B,
sets 4) runs under ``torchrun --nproc-per-node <tp>``: every rank judges
the same rows and rank 0 alone writes the files (``--dist_backend gloo
--device cuda:0`` puts every rank on one card).

``--gpt`` and ``--llm_ollama`` call remote services and are not ported.
"""

import argparse
import json
import os
import shutil

from bergen_tpu_torch.parallel import mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GENERATOR_CONFIG_DIR = os.path.join(REPO, "config", "generator")


def load_data(input_file: str, nb_samples: int):
    with open(input_file) as f:
        rows = json.load(f)
    if 0 < nb_samples < len(rows):
        rows = rows[:nb_samples]
    return rows


def load_opponent_predictions(opponent_folder: str, split: str, rows):
    with open(f"{opponent_folder}/eval_{split}_out.json") as f:
        other = json.load(f)
    by_qid = {r["q_id"]: r for r in other}
    q_ids = [r["q_id"] for r in rows]
    missing = [q for q in q_ids if q not in by_qid]
    if missing:
        raise ValueError(f"opponent folder missing q_ids: {missing[:5]}")
    return [by_qid[q]["response"] for q in q_ids]


def _experiment_folders(experiment_folder, folder):
    if folder is not None:
        return [folder]
    return [f.path for f in os.scandir(experiment_folder)
            if f.is_dir() and "tmp_" not in f.path]


def eval_single(experiment_folder, folder, split, model, metric_name,
                nb_samples=-1, opponent_folder=None, force=False):
    if nb_samples > 0:
        metric_name = f"{metric_name}_{nb_samples}"
    for exp in _experiment_folders(experiment_folder, folder):
        input_file = f"{exp}/eval_{split}_out.json"
        if not os.path.exists(input_file):
            continue
        rows = load_data(input_file, nb_samples)

        metrics_file = f"{exp}/eval_{split}_metrics.json"
        metrics_dict = {}
        if os.path.exists(metrics_file):
            with open(metrics_file) as f:
                metrics_dict = json.load(f)
        if (metric_name in metrics_dict or f"{metric_name}_tie" in metrics_dict) \
                and not force:
            print(f"{exp}\t{metric_name}\talready done")
            continue

        predictions = [r["response"] for r in rows]
        references = [r["label"] for r in rows]
        questions = [r["question"] for r in rows]

        if opponent_folder is None:
            model_score, scores = model(predictions, references, questions)
        else:
            opponent = load_opponent_predictions(opponent_folder, split, rows)
            model_score, scores = model(
                predictions=predictions, references=references,
                questions=questions, opponent_predictions=opponent,
            )

        if mesh.rank() != 0:
            continue  # rank 0 writes what every rank computed
        for r, s in zip(rows, scores):
            r[metric_name] = s
        out_file = input_file if nb_samples <= 0 else f"{exp}/eval_{split}_out_{nb_samples}.json"
        with open(out_file + "_", "w") as f:
            json.dump(rows, f, indent=2)
        shutil.move(out_file + "_", out_file)

        if isinstance(model_score, dict):  # pairwise win/tie/lose
            metrics_dict.update(
                {f"{metric_name}_{k}": v for k, v in model_score.items()}
            )
        else:
            metrics_dict[metric_name] = model_score
        print(metric_name, model_score)
        with open(metrics_file + "_", "w") as f:
            json.dump(metrics_dict, f, indent=2)
        shutil.move(metrics_file + "_", metrics_file)


def llm_eval(llm, experiment_folder, folder, split, batch_size, llm_prompt,
             opponent_folder, opponent_name, nb_samples, force,
             generator_config_dir=GENERATOR_CONFIG_DIR, device=None):
    from bergen_tpu_torch import confy
    from bergen_tpu_torch.models.evaluators.llm import LLMeval

    if len(llm) == 0:
        model_config_name, metric_name = "SOLAR-107B", "LLMeval_SOLAR-107B"
    else:
        model_config_name = llm[0]
        metric_name = f"LLMeval_{llm[1] if len(llm) > 1 else model_config_name}"
    if opponent_folder is not None:
        metric_name += "_VS_" + opponent_name

    model_config = confy.load_yaml(
        os.path.join(generator_config_dir, f"{model_config_name}.yaml"))
    model = LLMeval(model_config, batch_size=batch_size, config=llm_prompt,
                    device=device)
    if model.use_logits:
        if opponent_folder is not None:
            model.use_logits = False
        else:
            metric_name = f"{metric_name}_logits"
    eval_single(experiment_folder, folder, split, model, metric_name=metric_name,
                nb_samples=nb_samples, opponent_folder=opponent_folder, force=force)


def lid_eval(lid, lid_advanced, experiment_folder, folder, split, nb_samples, force):
    import yaml

    from bergen_tpu_torch.models.evaluators.lid import LID, LID_advanced

    for exp in _experiment_folders(experiment_folder, folder):
        with open(f"{exp}/config.yaml") as f:
            config = yaml.safe_load(f)
        init_args = config["dataset"][split]["query"]["init_args"]
        tgt_lng = init_args.get("lng") or init_args.get("lang") or "en"
        if lid is not None:
            eval_single(experiment_folder, exp, split, LID(tgt_lng),
                        metric_name="lid", nb_samples=nb_samples, force=force)
        if lid_advanced is not None:
            eval_single(experiment_folder, exp, split, LID_advanced(tgt_lng),
                        metric_name="lid_advanced", nb_samples=nb_samples,
                        force=force)


def run_eval(experiment_folder=None, split="dev", llm=None, llm_ollama=None,
             gpt=None, lid=None, lid_advanced=None, llm_batch_size=None,
             llm_prompt="default_qa", folder=None, force=False, nb_samples=-1,
             opponent_folder=None, opponent_name=None,
             generator_config_dir=GENERATOR_CONFIG_DIR, device=None):
    if gpt is not None or llm_ollama is not None:
        raise NotImplementedError(
            "--gpt and --llm_ollama call remote services, which the port does "
            "not reach (ROADMAP.md Queue 1, evaluators and CLIs)")
    if llm is not None:
        llm_eval(llm, experiment_folder, folder, split, llm_batch_size,
                 llm_prompt, opponent_folder, opponent_name, nb_samples, force,
                 generator_config_dir=generator_config_dir, device=device)
    if lid is not None or lid_advanced is not None:
        lid_eval(lid, lid_advanced, experiment_folder, folder, split,
                 nb_samples, force)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--experiments_folder", type=str, default="experiments/")
    parser.add_argument("--folder", type=str, default=None)
    parser.add_argument("--split", type=str, default="dev")
    parser.add_argument("--sample", type=int, default=-1)
    parser.add_argument("--lid", action="store_true", default=None)
    parser.add_argument("--lid_advanced", action="store_true", default=None)
    parser.add_argument("--llm", type=str, nargs="*", default=None)
    parser.add_argument("--llm_ollama", type=str, nargs="*", default=None)
    parser.add_argument("--gpt", type=str, default=None)
    parser.add_argument("--opponent_folder", type=str, default=None)
    parser.add_argument("--opponent_name", type=str, default=None)
    parser.add_argument("--llm_batch_size", type=int, default=None)
    parser.add_argument("--force", action="store_true")
    parser.add_argument("--llm_prompt", type=str, default="default_qa")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cpu, cuda, or cuda:N (every rank on card N: "
                        "--dist_backend gloo)")
    parser.add_argument("--dist_backend", type=str, default=None,
                        choices=["nccl", "gloo"])
    args = parser.parse_args(argv)
    device = args.device
    if mesh.world_size() > 1:  # under torchrun: this rank's device
        device = mesh.init(device, args.dist_backend).device

    if args.opponent_folder is not None:
        if args.llm is None:
            parser.error("pairwise judging needs --llm")
        if args.folder is None:
            parser.error("pairwise needs an explicit --folder")
        if not os.path.isdir(args.opponent_folder):
            parser.error(f"no folder {args.opponent_folder}")
        if args.opponent_name is None:
            parser.error("pairwise needs --opponent_name")

    run_eval(
        folder=args.folder, experiment_folder=args.experiments_folder,
        split=args.split, llm=args.llm, llm_ollama=args.llm_ollama, gpt=args.gpt,
        lid=args.lid, lid_advanced=args.lid_advanced,
        llm_batch_size=args.llm_batch_size, llm_prompt=args.llm_prompt,
        force=args.force, nb_samples=args.sample,
        opponent_folder=args.opponent_folder, opponent_name=args.opponent_name,
        device=device,
    )


if __name__ == "__main__":
    main()
