"""FedPERSONA: PersonaChat with one personality per client, the port's
copy of ``commefficient_tpu/data_utils/fed_persona.py`` (numpy and the
standard library only; the same seed gives the same partition, items and
batches).

- ``prepare_datasets`` partitions the raw PersonaChat json by personality
  into per-client json shards and ``stats.json``; with no
  ``personachat_self_original.json`` under the dataset directory it
  writes the seeded synthetic corpus (``_synthetic_personachat``,
  ``COMMEFFICIENT_SYNTHETIC_CLIENTS`` personalities);
- a flat utterance index maps to (dialog, client) by the double cumsum;
  val items carry the client id -1;
- ``utterance_to_input`` keeps the last ``2 * max_history + 1`` history
  turns and, in training, the last ``num_candidates`` candidates;
  ``personality_permutations`` shuffles the persona with the global
  ``random`` module, as the JAX package does;
- ``build_input_from_segments`` assembles ``[bos] + persona``, the
  speaker-tagged history and the reply (+ eos), with alternating
  ``token_type_ids``, ``mc_token_ids`` at the last position and
  ``lm_labels`` -1 except on the correct (last) candidate's reply;
- ``make_personachat_collate_fn`` gives static ``(B, num_candidates,
  max_seq_len)`` arrays, left-truncating an over-long sequence so the
  reply and the classification token survive; with ``emit_shifted``
  (sequence parallelism) it adds ``lm_labels_shifted``, the next-token
  targets shifted over the global sequence;
- ``personachat_collate_fn`` is the reference's ragged collate (padded to
  the batch's longest sequence), kept for the API.
"""

from __future__ import annotations

import json
import os
import random
from collections import defaultdict
from itertools import chain

import numpy as np

from commefficient_torch.data_utils.fed_dataset import FedDataset
from commefficient_torch.data_utils.tokenization import SPECIAL_TOKENS

__all__ = ["FedPERSONA", "make_personachat_collate_fn",
           "personachat_collate_fn", "build_input_from_segments"]

MODEL_INPUTS = ["input_ids", "mc_token_ids", "lm_labels", "mc_labels",
                "token_type_ids"]
PADDED_INPUTS = ["input_ids", "lm_labels", "token_type_ids"]


def _synthetic_personachat(seed=0):
    n_clients = int(os.environ.get("COMMEFFICIENT_SYNTHETIC_CLIENTS", 24))
    rng = random.Random(seed)
    words = ["i", "like", "cats", "dogs", "music", "hiking", "pizza", "code",
             "tpus", "sketches", "running", "tea", "books", "rain", "sun"]

    def sentence():
        return " ".join(rng.choice(words) for _ in range(rng.randint(3, 7)))

    def dialog():
        n_utt = rng.randint(2, 4)
        utterances = []
        history = [sentence()]
        for _ in range(n_utt):
            utterances.append({
                "history": list(history),
                "candidates": [sentence() for _ in range(3)],
            })
            history.append(sentence())
            history.append(utterances[-1]["candidates"][-1])
        return utterances

    def split(n):
        out = []
        for _ in range(n):
            out.append({
                "personality": [sentence() for _ in range(4)],
                "utterances": dialog(),
            })
        return out

    return {"train": split(n_clients), "valid": split(max(2, n_clients // 8))}


def tokenize(obj, tokenizer):
    if isinstance(obj, str):
        return tokenizer.convert_tokens_to_ids(tokenizer.tokenize(obj))
    if isinstance(obj, dict):
        return {n: tokenize(o, tokenizer) for n, o in obj.items()}
    return [tokenize(o, tokenizer) for o in obj]


def build_input_from_segments(persona, history, reply, tokenizer,
                              lm_labels=False, with_eos=True):
    """persona/history/reply are token-id lists (reference
    fed_persona.py:330-358)."""
    bos, eos, speaker1, speaker2 = tokenizer.convert_tokens_to_ids(
        SPECIAL_TOKENS[:-1])
    sequence = [[bos] + list(chain(*persona))] + history
    sequence = sequence + [reply + ([eos] if with_eos else [])]
    sequence = [sequence[0]] + [
        [speaker2 if (len(sequence) - i) % 2 == 0 else speaker1] + s
        for i, s in enumerate(sequence[1:])
    ]
    instance = {
        "input_ids": list(chain(*sequence)),
        "token_type_ids": [speaker2 if i % 2 else speaker1
                           for i, s in enumerate(sequence) for _ in s],
    }
    instance["mc_token_ids"] = len(instance["input_ids"]) - 1
    instance["lm_labels"] = [-1] * len(instance["input_ids"])
    if lm_labels:
        instance["lm_labels"] = ([-1] * sum(len(s) for s in sequence[:-1])
                                 + [-1] + sequence[-1][1:])
    return instance


def raw_to_input(tokenizer, personality, history, candidates):
    personality = tokenize(personality, tokenizer)
    history = tokenize(history, tokenizer)
    candidates = tokenize(candidates, tokenizer)
    model_input = defaultdict(list)
    n = len(candidates)
    for j, candidate in enumerate(candidates):
        instance = build_input_from_segments(personality, history, candidate,
                                             tokenizer, lm_labels=(j == n - 1))
        for name, arr in instance.items():
            model_input[name].append(arr)
    model_input["mc_labels"] = n - 1
    return tuple(model_input[name] for name in MODEL_INPUTS)


class FedPERSONA(FedDataset):
    def __init__(self, tokenizer, num_candidates, max_history,
                 personality_permutations, *args, max_seq_len=256, **kwargs):
        self.tokenizer = tokenizer
        self.num_candidates = num_candidates
        self.max_history = max_history
        self.personality_permutations = personality_permutations
        self.max_seq_len = max_seq_len
        self._client_cache = {}
        super().__init__(*args, **kwargs)
        if self.type == "val":
            with open(self.validation_fn()) as f:
                self.raw_val_set = json.load(f)

    # -- metadata (dialog/utterance indexing, fed_persona.py:45-85) -------

    @property
    def data_per_client(self):
        if self.do_iid:
            num_data = len(self)
            upc = np.full(self.num_clients, num_data // self.num_clients,
                          dtype=np.int64)
            extra = num_data % self.num_clients
            if extra:
                upc[self.num_clients - extra:] += 1
            return upc
        cumsum = np.hstack([[0], np.cumsum(self.dialogs_per_client)])
        return np.array([
            sum(self.train_utterances_per_dialog[s:s + n])
            for s, n in zip(cumsum, self.dialogs_per_client)
        ])

    @property
    def num_clients(self):
        if self.do_iid and self._num_clients is not None:
            return self._num_clients
        return len(self.dialogs_per_client)

    def _load_meta(self, train):
        with open(self.stats_fn()) as f:
            stats = json.load(f)
        self.dialogs_per_client = stats["dialogs_per_client"]
        self.train_utterances_per_dialog = stats["train_utterances_per_dialog"]
        self.val_utterances_per_dialog = stats["val_utterances_per_dialog"]

    def __len__(self):
        if self.type == "train":
            return int(sum(self.train_utterances_per_dialog))
        return int(sum(self.val_utterances_per_dialog))

    # -- preparation -------------------------------------------------------

    def prepare_datasets(self, download=False):
        raw_path = os.path.join(self.dataset_dir,
                                "personachat_self_original.json")
        if os.path.exists(raw_path):
            with open(raw_path) as f:
                raw = json.load(f)
        else:
            raw = _synthetic_personachat()

        val_set = raw["valid"]
        val_upd = [len(d["utterances"]) for d in val_set]

        by_personality = defaultdict(list)
        for dialog in raw["train"]:
            by_personality[tuple(dialog["personality"])].append(dialog)

        dialogs_per_client, train_upd = [], []
        for cid, (personality, dialogs) in enumerate(by_personality.items()):
            dialogs_per_client.append(len(dialogs))
            train_upd.extend(len(d["utterances"]) for d in dialogs)
            with open(self.client_fn(cid), "w") as f:
                json.dump(dialogs, f)

        with open(self.validation_fn(), "w") as f:
            json.dump(val_set, f)
        with open(self.stats_fn(), "w") as f:
            json.dump({"dialogs_per_client": dialogs_per_client,
                       "train_utterances_per_dialog": train_upd,
                       "val_utterances_per_dialog": val_upd,
                       # images_per_client kept for base-class compat
                       "images_per_client": dialogs_per_client,
                       "num_val_images": int(sum(val_upd))}, f)

    # -- item access -------------------------------------------------------

    def __getitem__(self, idx):
        if self.type == "train":
            return self._get_train_utterance(idx)
        return self._get_val_utterance(idx)

    def _client_dialogs(self, client_id):
        if client_id not in self._client_cache:
            with open(self.client_fn(client_id)) as f:
                self._client_cache[client_id] = json.load(f)
        return self._client_cache[client_id]

    def _get_train_utterance(self, idx):
        orig_idx = idx
        if self.do_iid:
            idx = self.iid_shuffle[idx]
        cumsum = np.cumsum(self.train_utterances_per_dialog)
        dialog_id = int(np.searchsorted(cumsum, idx, side="right"))
        start = cumsum[dialog_id - 1] if dialog_id else 0
        idx_within_dialog = int(idx - start)

        cumsum_d = np.cumsum(self.dialogs_per_client)
        client_id = int(np.searchsorted(cumsum_d, dialog_id, side="right"))
        start_d = cumsum_d[client_id - 1] if client_id else 0
        idx_within_client = int(dialog_id - start_d)

        dialog = self._client_dialogs(client_id)[idx_within_client]
        personality = list(dialog["personality"])
        utterance = dialog["utterances"][idx_within_dialog]

        model_input = None
        for _ in range(self.personality_permutations):
            random.shuffle(personality)
            model_input = self.utterance_to_input(personality, utterance)

        if self.do_iid:
            cumsum_c = np.cumsum(self.data_per_client)
            client_id = int(np.searchsorted(cumsum_c, orig_idx, side="right"))
        return (client_id,) + model_input

    def _get_val_utterance(self, idx):
        cumsum = np.cumsum(self.val_utterances_per_dialog)
        dialog_id = int(np.searchsorted(cumsum, idx, side="right"))
        start = cumsum[dialog_id - 1] if dialog_id else 0
        dialog = self.raw_val_set[dialog_id]
        utterance = dialog["utterances"][int(idx - start)]
        return (-1,) + self.utterance_to_input(dialog["personality"],
                                               utterance)

    def utterance_to_input(self, personality, utterance):
        history = utterance["history"][-(2 * self.max_history + 1):]
        candidates = utterance["candidates"]
        n = len(candidates)
        if self.num_candidates > 0 and self.type == "train":
            n = min(self.num_candidates, n)
        candidates = candidates[-n:]
        return raw_to_input(self.tokenizer, personality, history, candidates)

    def client_fn(self, client_id):
        return os.path.join(self.dataset_dir, f"client{client_id}.json")

    def validation_fn(self):
        return os.path.join(self.dataset_dir, "validation.json")


def make_personachat_collate_fn(max_seq_len: int, num_candidates: int,
                                emit_shifted: bool = False):
    """Static-shape collate: ``(B, num_candidates, max_seq_len)`` padded
    arrays (the reference pads to the per-batch maximum; the port keeps
    the JAX package's fixed width). ``emit_shifted`` adds
    ``lm_labels_shifted``: the target of position t (``lm_labels[t +
    1]``, -1 at the last slot), which the seq-parallel loss needs because
    the shift crosses the ranks' slices of the sequence."""

    def collate(items):
        B = len(items)
        C, T = num_candidates, max_seq_len
        input_ids = np.zeros((B, C, T), np.int64)
        token_type_ids = np.zeros((B, C, T), np.int64)
        lm_labels = np.full((B, C, T), -1, np.int64)
        mc_token_ids = np.zeros((B, C), np.int64)
        mc_labels = np.zeros((B,), np.int64)
        for b, item in enumerate(items):
            ids, mc_tok, lm, mc_lab, tt = item
            n = min(len(ids), C)
            mc_labels[b] = min(mc_lab, C - 1)
            for c in range(n):
                # left-truncate: the gold reply (the only labels) and the
                # classification token sit at the tail of the sequence
                off = max(0, len(ids[c]) - T)
                seq = ids[c][off:]
                L = len(seq)
                input_ids[b, c, :L] = seq
                token_type_ids[b, c, :L] = tt[c][off:]
                lm_labels[b, c, :L] = lm[c][off:]
                mc_token_ids[b, c] = min(max(mc_tok[c] - off, 0), L - 1,
                                         T - 1)
        out = {
            "input_ids": input_ids,
            "mc_token_ids": mc_token_ids,
            "lm_labels": lm_labels,
            "mc_labels": mc_labels,
            "token_type_ids": token_type_ids,
        }
        if emit_shifted:
            shifted = np.full_like(lm_labels, -1)
            shifted[..., :-1] = lm_labels[..., 1:]
            out["lm_labels_shifted"] = shifted
        return out

    return collate


def personachat_collate_fn(records):
    """The reference's ragged collate: ``(client_id, *MODEL_INPUTS)`` with
    the padded inputs at the batch's longest sequence (ids and token
    types padded with 0, ``lm_labels`` with -1), ``(B, candidates, L)``;
    the rest stacked."""
    max_l = max(len(ids) for record in records for ids in record[1])
    ncand = len(records[0][1])
    out = []
    for i, name in enumerate(["client_id"] + MODEL_INPUTS):
        if name in PADDED_INPUTS:
            pad_val = 0 if name != "lm_labels" else -1
            seqs = [s for record in records for s in record[i]]
            padded = np.full((len(seqs), max_l), pad_val, np.int64)
            for r, s in enumerate(seqs):
                padded[r, :len(s)] = s
            out.append(padded.reshape(len(records), ncand, -1))
        else:
            out.append(np.asarray([record[i] for record in records]))
    return tuple(out)
