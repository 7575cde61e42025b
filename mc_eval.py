"""Offline multiple-choice eval tasks (arc / piqa / generic jsonl).

Extends the built-in task set toward the reference's lm-eval harness
breadth (llm_evaluate.py:51-56) with the harness's standard min-summed-CE
classification recipe (the same scoring hellaswag.py uses): tokenize
context+choice, sum the CE of the continuation tokens, predict the
argmin choice. All tasks run from LOCAL jsonl (zero-egress environment).

Row formats (one JSON object per line):
  arc:  {"question": str, "choices": {"text": [...], "label": [...]},
         "answerKey": "B"}            (ARC-Easy/Challenge HF schema)
  piqa: {"goal": str, "sol1": str, "sol2": str, "label": 0|1}
  mc:   {"ctx": str, "choices": [str, ...], "gold": int}   (generic)

Like hellaswag.py the token tensor is FIXED-shape (N, n_choices, max_len)
so the jitted predictor never recompiles; rows with fewer choices than
the task maximum are padded with invalid choices masked to +inf loss.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np


def _fmt_arc(row):
    texts = row["choices"]["text"]
    labels = [str(l) for l in row["choices"]["label"]]
    gold = labels.index(str(row["answerKey"]))
    ctx = f"Question: {row['question']}\nAnswer:"
    return ctx, [f" {t}" for t in texts], gold


def _fmt_piqa(row):
    ctx = f"Question: {row['goal']}\nAnswer:"
    return ctx, [f" {row['sol1']}", f" {row['sol2']}"], int(row["label"])


def _fmt_mc(row):
    return row["ctx"], list(row["choices"]), int(row["gold"])


FORMATS = {"arc": _fmt_arc, "piqa": _fmt_piqa, "mc": _fmt_mc}


def int_tokenizer(s: str):
    """Tokenizer for token-level tasks: the 'text' is space-joined token
    ids (used by the Markov-chain MC task, which has no surface text)."""
    return [int(t) for t in s.split()]


def generate_markov_mc(
    out_path: str,
    n_rows: int = 400,
    prompt_len: int = 48,
    cont_len: int = 8,
    n_choices: int = 4,
    seed: int = 2024,
    vocab_size: int = 32000,
    n_states: int = 2048,
    branching: int = 8,
) -> str:
    """Write an 'mc'-format jsonl task derived from the SAME Markov chain
    the convergence runs train on (data.MarkovTokenDataset, eval split).

    Each row: prompt = a sampled trajectory prefix; gold choice = its
    true sampled continuation; distractors = true continuations of OTHER
    rows (valid chain fragments that don't follow from this prompt's
    final state). A model trained on the chain scores far above the
    1/n_choices floor; an untrained model sits at it. This is the
    zero-egress stand-in for the north star's "hellaswag accuracy within
    the reference's int8 delta" clause — same scoring recipe
    (min-summed-continuation-CE), locally generatable labels.
    """
    from quantized_training_tpu.data.text import MarkovTokenDataset

    ds = MarkovTokenDataset(
        seq_len=prompt_len + cont_len,
        vocab_size=vocab_size,
        n_states=n_states,
        branching=branching,
        eval=True,
        seed=seed,
        n_samples=n_rows,
    )
    samples = [tok for tok, _ in ds]
    # enforce the docstring's invariant: a distractor must NOT follow from
    # this prompt's final state — without the filter ~n_choices*branching/
    # n_states of rows get a second chain-valid continuation, capping even
    # a perfect model below 1.0 (the round-3 parity table's uniform 0.990
    # was partly this ceiling, not model error)
    tok_to_state = {int(t): s for s, t in enumerate(ds._state_to_tok)}
    rng = np.random.Generator(np.random.PCG64([seed, 0x4D43]))  # "MC"
    rows = []
    for i, toks in enumerate(samples):
        prompt = toks[:prompt_len]
        gold_cont = toks[prompt_len:]
        last_state = tok_to_state[int(prompt[-1])]
        valid_next = {
            int(ds._state_to_tok[s]) for s in ds._succ[last_state]
        }
        # distractors: continuations of OTHER rows whose first token is
        # not a legal successor of this prompt's final state
        pool = [
            j for j in range(n_rows)
            if j != i and int(samples[j][prompt_len]) not in valid_next
        ]
        others = rng.choice(pool, n_choices - 1, replace=False)
        conts = [gold_cont] + [samples[j][prompt_len:] for j in others]
        order = rng.permutation(n_choices)
        rows.append(
            {
                "ctx": " ".join(map(str, prompt)),
                "choices": [
                    " " + " ".join(map(str, conts[k])) for k in order
                ],
                "gold": int(np.argwhere(order == 0)[0, 0]),
            }
        )
    with open(out_path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return out_path


def load_rows(data_path: str):
    with open(data_path) as f:
        return [json.loads(line) for line in f if line.strip()]


def tokenize_mc(rows, fmt, tokenizer, max_len: int | None = None):
    """-> tokens [N, C, L] (pad/ctx-only = -100 in the LABEL view),
    gold [N], choice_valid [N, C].

    Continuation scoring: only the choice's tokens count toward the loss
    — context tokens are marked -100 like padding (the lm-eval
    ``loglikelihood`` contract), which hellaswag.py approximates by
    scoring the full sequence; here we do the exact continuation-only
    version.
    """
    parsed = [fmt(r) for r in rows]
    n_choices = max(len(ch) for _, ch, _ in parsed)

    seqs = []
    for ctx, choices, gold in parsed:
        ctx_toks = tokenizer(ctx)
        row_seqs = []
        for ch in choices:
            full = tokenizer(ctx + ch)
            # continuation tokens = the suffix beyond the longest common
            # prefix with ctx_toks (robust to tokenizer merges at the seam)
            p = 0
            while p < min(len(ctx_toks), len(full)) and ctx_toks[p] == full[p]:
                p += 1
            row_seqs.append((full, max(p, 1)))
        seqs.append((row_seqs, gold))

    L = max_len or max(
        len(full) for row_seqs, _ in seqs for full, _ in row_seqs
    )
    N = len(seqs)
    tokens = np.full((N, n_choices, L), 0, dtype=np.int64)
    score_mask = np.zeros((N, n_choices, L), dtype=bool)
    gold_arr = np.zeros(N, dtype=np.int64)
    valid = np.zeros((N, n_choices), dtype=bool)
    for i, (row_seqs, gold) in enumerate(seqs):
        gold_arr[i] = gold
        for j, (full, p) in enumerate(row_seqs):
            full = full[:L]
            tokens[i, j, : len(full)] = full
            score_mask[i, j, min(p, len(full)) : len(full)] = True
            valid[i, j] = True
    return tokens, score_mask, gold_arr, valid


def make_predict(cfg):
    from quantized_training_tpu.models import llama

    @jax.jit
    def predict(params, tokens, score_mask, choice_valid):
        N, C, L = tokens.shape
        inputs = tokens[..., :-1].reshape(N * C, L - 1).astype(jnp.int32)
        logits = llama.forward(params, inputs, cfg).astype(jnp.float32)
        targets = tokens[..., 1:].reshape(N * C, L - 1)
        mask = score_mask[..., 1:].reshape(N * C, L - 1)
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]
        loss = jnp.where(mask, nll, 0.0).reshape(N, C, L - 1).sum(-1)
        loss = jnp.where(choice_valid, loss, jnp.inf)
        return jnp.argmin(loss, axis=-1)

    return predict


def evaluate_mc(
    params,
    cfg,
    task: str,
    data_path: str,
    tokenizer: str = "llama3",
    batch_size: int = 8,
    max_rows: int | None = None,
) -> float:
    from quantized_training_tpu.data import get_tokenizer

    rows = load_rows(data_path)
    if max_rows is not None:
        rows = rows[:max_rows]
    if tokenizer == "ints":
        tok = int_tokenizer
    else:
        tok = get_tokenizer(tokenizer) if isinstance(tokenizer, str) else tokenizer
    tokens, score_mask, gold, valid = tokenize_mc(rows, FORMATS[task], tok)

    predict = make_predict(cfg)
    n_correct = 0
    # score EVERY row: the final partial batch is padded up by repeating
    # the last row (shapes stay fixed — no recompile), and the pad
    # predictions are sliced off before scoring
    n = len(tokens)
    for i in range(0, n, batch_size):
        sl = slice(i, min(i + batch_size, n))
        # ragged tail: pad the batch up by repeating the last row
        t, m, v = tokens[sl], score_mask[sl], valid[sl]
        pad = batch_size - len(t)
        if pad:
            t = np.concatenate([t, np.repeat(t[-1:], pad, 0)])
            m = np.concatenate([m, np.repeat(m[-1:], pad, 0)])
            v = np.concatenate([v, np.repeat(v[-1:], pad, 0)])
        preds = predict(params, jnp.asarray(t), jnp.asarray(m), jnp.asarray(v))
        preds = np.asarray(preds)[: sl.stop - sl.start]
        n_correct += int((preds == gold[sl]).sum())
    return n_correct / max(n, 1)


if __name__ == "__main__":
    import argparse

    # generation is pure numpy — never touch the (possibly busy) card
    jax.config.update("jax_platforms", "cpu")

    p = argparse.ArgumentParser(
        description="Generate the Markov-chain MC task (writes 'mc' jsonl; "
        "evaluate with llm_evaluate.py --tasks mc --task_data <path> "
        "--hellaswag_tokenizer ints)"
    )
    p.add_argument("out_path")
    p.add_argument("--n_rows", type=int, default=400)
    p.add_argument("--prompt_len", type=int, default=48)
    p.add_argument("--cont_len", type=int, default=8)
    p.add_argument("--n_choices", type=int, default=4)
    p.add_argument("--seed", type=int, default=2024)
    p.add_argument("--vocab_size", type=int, default=32000)
    p.add_argument("--n_states", type=int, default=2048)
    p.add_argument("--branching", type=int, default=8)
    a = p.parse_args()
    path = generate_markov_mc(**vars(a))
    print(f"wrote {a.n_rows} rows to {path}")
