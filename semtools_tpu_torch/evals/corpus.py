"""Deterministic synthetic-text corpus for the retrieval and agent evaluations.

Counterpart of the repository's ``benchmarks/arxiv/gen_text_corpus.py``:
for the same ``n_papers`` and ``seed`` its files and its truth are
byte-equal to that generator's. Every paper is generated from one or two
topic vocabularies, so "which papers are relevant to topic T" is known by
construction and retrieval quality is scoreable without an LLM judge.

Layout:
    <root>/full_text/<id>.txt
    <root>/by_date/<YYYY-MM>/<id>.txt      (copy)
    <root>/ground_truth.json               {topic: [paper ids]}

Papers are ~40-80 lines: a title, an abstract block, and section text
sampled from the paper's topic banks mixed with generic academic filler.
Exact-match probes are planted deterministically: 'diffusion' appears in
the titles of exactly the diffusion papers, '_v3' in a known subset of
filenames, and 'state space model' first appears in a title in a known
month.
"""

from __future__ import annotations

import json
import random
from pathlib import Path

TOPICS = {
    "attention": [
        "attention mechanisms let neural networks weigh context tokens",
        "self-attention layers route information between distant tokens",
        "multi-head attention projects queries keys and values per head",
        "cross-attention lets the decoder attend over encoder states",
        "attention weights form a softmax distribution over positions",
        "linear attention approximations reduce the quadratic cost",
        "sparse attention patterns trade coverage for throughput",
    ],
    "diffusion": [
        "the forward process gradually corrupts samples with gaussian noise",
        "a denoising network predicts the score at each noise level",
        "classifier-free guidance trades diversity for sample fidelity",
        "latent diffusion operates in a learned compressed space",
        "samplers like ddim cut the number of denoising steps",
    ],
    "optimizers": [
        "adaptive moment estimation rescales updates per parameter",
        "learning rate warmup stabilizes early training dynamics",
        "weight decay decouples regularization from the gradient step",
        "second-order preconditioning accelerates ill-conditioned losses",
        "cosine schedules anneal the step size to zero",
    ],
    "medical-imaging": [
        "segmentation of radiology scans assists clinical diagnosis",
        "data augmentation mitigates the scarcity of labeled mri volumes",
        "tumor detection models flag suspicious lesions for review",
        "cross-hospital validation exposes distribution shift in ct data",
        "u-shaped encoder decoder networks dominate medical segmentation",
    ],
    "rl-robotics": [
        "deep reinforcement learning lets robots acquire control policies",
        "policy gradients optimize expected return through rollouts",
        "sim-to-real transfer bridges the simulation reality gap",
        "reward shaping guides exploration in sparse environments",
        "model predictive control plans over learned dynamics",
        "robotic grasping benefits from tactile feedback policies",
    ],
    "contrastive": [
        "contrastive learning pulls positive pairs together in embedding space",
        "large batches supply the negatives that sharpen the objective",
        "momentum encoders stabilize the target representation",
        "augmentation strength controls the difficulty of positives",
    ],
    "state-space": [
        "structured state space models capture long-range dependencies",
        "selective scan mechanisms gate the recurrent state updates",
        "diagonal parameterizations make the recurrence trainable",
    ],
    "agents": [
        "autonomous agents decompose goals into tool-use steps",
        "an agent loop alternates planning acting and reflecting",
        "multi-agent coordination emerges from shared memory",
    ],
    "vision-language": [
        "vision transformers adapt language-model pretraining to pixels",
        "image captioning grounds visual features in fluent text",
        "prompt tuning steers frozen vision language backbones",
    ],
}

FILLER = [
    "we evaluate on standard benchmarks and report mean results",
    "ablations isolate the contribution of each component",
    "related work spans several adjacent research threads",
    "the appendix lists hyperparameters for reproducibility",
    "our implementation builds on open source tooling",
    "error bars denote the standard deviation over three seeds",
    "we discuss limitations and directions for future work",
    "experiments ran on commodity accelerators",
]

MONTHS = ["2025-01", "2025-02", "2025-03", "2025-04", "2025-05", "2025-06"]
# 'state space model' first appears in a TITLE in this month (exact probe c2)
SSM_TITLE_MONTH = "2025-04"


def gen(root: Path, n_papers: int = 400, seed: int = 7) -> dict:
    rng = random.Random(seed)
    full = root / "full_text"
    full.mkdir(parents=True, exist_ok=True)
    topics = list(TOPICS)
    truth: dict = {t: [] for t in topics}
    truth["_v3_files"] = []
    truth["_diffusion_titles"] = []
    truth["_ssm_title_month"] = SSM_TITLE_MONTH
    truth["_months"] = {}

    for i in range(n_papers):
        main = topics[i % len(topics)]
        second = rng.choice([None] + [t for t in topics if t != main])
        month = MONTHS[rng.randrange(len(MONTHS))]
        pid = f"{2500 + i:04d}.{rng.randrange(10000, 99999)}"
        if rng.random() < 0.08:
            pid += "_v3"
            truth["_v3_files"].append(pid)

        lines = []
        if main == "diffusion":
            lines.append(f"Denoising Diffusion Approaches to {second or 'Generation'} ({pid})")
            truth["_diffusion_titles"].append(pid)
        elif main == "state-space" and month >= SSM_TITLE_MONTH:
            lines.append(f"A State Space Model Perspective on Sequences ({pid})")
        else:
            lines.append(f"A Study of {main.replace('-', ' ').title()} Methods ({pid})")
        lines.append("")
        lines.append("Abstract")
        bank = list(TOPICS[main]) + (list(TOPICS[second]) if second else [])
        n_lines = rng.randrange(40, 80)
        for _ in range(n_lines):
            if rng.random() < 0.55:
                lines.append(rng.choice(bank))
            else:
                lines.append(rng.choice(FILLER))

        text = "\n".join(lines) + "\n"
        (full / f"{pid}.txt").write_text(text)
        mdir = root / "by_date" / month
        mdir.mkdir(parents=True, exist_ok=True)
        (mdir / f"{pid}.txt").write_text(text)

        truth[main].append(pid)
        if second:
            truth[second].append(pid)
        truth["_months"][pid] = month

    (root / "ground_truth.json").write_text(json.dumps(truth, indent=1))
    return truth

