"""Agentic RL: environments and their rollout loops.

The port's counterpart of socioreasoner_tpu/pipeline/agentic/
environment_worker.py. A multi-turn loop in which the policy emits an action
a turn and the environment answers with an observation, a reward and a done
flag; environments follow the small protocol of BaseEnv and are built by name
from ENV_REGISTRY.

Two loops:
  EnvironmentWorker.run_rollout_loop — text environments against a policy
    `generate_fn(prompt_text) -> action_text` (the text AgenticPipeline);
  EnvManager.run_episode — one environment's episode through a
    RequestScheduler, for VLM environments whose observations carry images:
    every turn's prompt holds the whole history (the image placeholders
    expanded to their merged token counts, each image's ViT rows computed
    once, on the turn it arrives, and kept as tensors on the device) and the
    engine's sampled action ids enter the sequence verbatim, but for the
    vision special ids (see `vision_token_ids`), which are dropped and
    counted: a sampled <|image_pad|> would be one image token more than the
    episode has image rows, and the next turn's M-RoPE ids would fail on it.
    The JAX package appends them and raises IndexError on that turn.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...models.qwen2_5_vl.rope import get_rope_index
from ...protocol import BatchProto
from ...runtime.dispatch import Dispatch, register
from ...runtime.worker import Worker

ENV_REGISTRY: Dict[str, Callable] = {}


def register_env(name: str):
    def deco(cls):
        ENV_REGISTRY[name] = cls
        return cls
    return deco


def make_env(name: str, **kwargs):
    if name not in ENV_REGISTRY:
        raise KeyError(f"unknown env {name!r}; have {sorted(ENV_REGISTRY)}")
    return ENV_REGISTRY[name](**kwargs)


class BaseEnv:
    """Text-interface environment protocol."""

    def reset(self, seed: Optional[int] = None) -> str:
        raise NotImplementedError

    def step(self, action: str) -> Tuple[str, float, bool, Dict]:
        """→ (observation, reward, done, info)."""
        raise NotImplementedError


@register_env("guess_number")
class GuessNumberEnv(BaseEnv):
    """Guess an integer in [low, high] with higher/lower feedback."""

    def __init__(self, low: int = 0, high: int = 100, max_turns: int = 10):
        self.low, self.high, self.max_turns = low, high, max_turns

    def reset(self, seed=None) -> str:
        rng = np.random.default_rng(seed)
        self.target = int(rng.integers(self.low, self.high + 1))
        self.turns = 0
        return (f"Guess the number between {self.low} and {self.high}. "
                "Answer with just a number.")

    def step(self, action: str):
        self.turns += 1
        try:
            guess = int("".join(c for c in action if c.isdigit() or c == "-") or "x")
        except ValueError:
            return "Not a number. Try again.", -0.1, self.turns >= self.max_turns, {}
        if guess == self.target:
            return "Correct!", 1.0, True, {"solved": True}
        hint = "higher" if guess < self.target else "lower"
        return f"Try {hint}.", -0.05, self.turns >= self.max_turns, {}


@dataclasses.dataclass
class Trajectory:
    observations: List[str] = dataclasses.field(default_factory=list)
    actions: List[str] = dataclasses.field(default_factory=list)
    rewards: List[float] = dataclasses.field(default_factory=list)
    done: bool = False
    info: Dict = dataclasses.field(default_factory=dict)

    @property
    def total_reward(self) -> float:
        return float(sum(self.rewards))


class EnvironmentWorker(Worker):
    """Runs a text environment's episodes against `generate_fn(prompt) ->
    action`; the prompt of a turn is the history joined by newlines."""

    @register(dispatch_mode=Dispatch.ONE_TO_ALL)
    def initialize(self, pipeline_config=None, env_name: str = "guess_number",
                   env_kwargs: Optional[Dict] = None,
                   generate_fn: Optional[Callable[[str], str]] = None,
                   max_turns: int = 10):
        super().initialize(pipeline_config)
        self.env = make_env(env_name, **(env_kwargs or {}))
        self.generate_fn = generate_fn
        self.max_turns = max_turns

    def run_rollout_loop(self, n_episodes: int, seed: int = 0) -> List[Trajectory]:
        trajectories = []
        for ep in range(n_episodes):
            traj = Trajectory()
            obs = self.env.reset(seed=seed + ep)
            history = [obs]
            for _ in range(self.max_turns):
                prompt = "\n".join(history)
                action = self.generate_fn(prompt)
                obs, reward, done, info = self.env.step(action)
                traj.observations.append(prompt)
                traj.actions.append(action)
                traj.rewards.append(reward)
                history.extend([action, obs])
                if done:
                    traj.done = True
                    traj.info = info
                    break
            trajectories.append(traj)
        return trajectories


# ------------------------------------------------------------ VLM environments
#
# An observation is a str or a dict {"text": str, "image": uint8 (H, W, 3)}.
# A multi-turn episode accumulates images: turn t's prompt carries the
# images of turns 1..t.


def _obs_parts(obs) -> Tuple[str, Optional[np.ndarray]]:
    if isinstance(obs, dict):
        return obs.get("text", ""), obs.get("image")
    return obs, None


@register_env("grid_goal")
class GridGoalEnv(BaseEnv):
    """A rendered grid shows the agent (a red square) and the goal (a green
    square); actions are the text moves up/down/left/right. The policy reads
    the positions from pixels, so every turn's prompt carries the growing
    image history."""

    def __init__(self, size: int = 4, cell_px: int = 28, max_turns: int = 8):
        self.size, self.cell_px, self.max_turns = size, cell_px, max_turns

    def _render(self) -> np.ndarray:
        px = self.cell_px
        img = np.full((self.size * px, self.size * px, 3), 230, np.uint8)
        img[::px, :, :] = 120
        img[:, ::px, :] = 120
        gy, gx = self.goal
        img[gy * px:(gy + 1) * px, gx * px:(gx + 1) * px] = (40, 200, 40)
        ay, ax = self.pos
        img[ay * px:(ay + 1) * px, ax * px:(ax + 1) * px] = (220, 40, 40)
        return img

    def reset(self, seed: Optional[int] = None):
        rng = np.random.default_rng(seed)
        self.pos = [int(rng.integers(self.size)), int(rng.integers(self.size))]
        while True:
            self.goal = [int(rng.integers(self.size)), int(rng.integers(self.size))]
            if self.goal != self.pos:
                break
        self.turns = 0
        return {"text": "You control the red square. Reach the green square. "
                        "Answer with one move: up, down, left or right.",
                "image": self._render()}

    def step(self, action: str):
        self.turns += 1
        act = action.lower()
        moves = {"up": (-1, 0), "down": (1, 0), "left": (0, -1), "right": (0, 1)}
        move = next((m for w, m in moves.items() if w in act), None)
        # the env's own format penalty, folded into the reward: "format" never
        # enters info, so EnvManager.format_penalty never applies
        penalty = 0.0 if move else -0.1
        if move:
            self.pos[0] = int(np.clip(self.pos[0] + move[0], 0, self.size - 1))
            self.pos[1] = int(np.clip(self.pos[1] + move[1], 0, self.size - 1))
        if self.pos == self.goal:
            return ({"text": "Goal reached!", "image": self._render()},
                    1.0, True, {"solved": True})
        done = self.turns >= self.max_turns
        return ({"text": "Current board:", "image": self._render()},
                penalty - 0.01, done, {})


@dataclasses.dataclass
class Episode:
    """One finished multi-turn episode, ready to train on.

    `input_ids` is the whole multi-turn sequence (the system block, the user
    blocks with their image tokens expanded, and the engine's sampled action
    ids, never decoded and encoded again, so the train step's log-probs see
    the sampled tokens); `response_mask` marks exactly those action ids.
    `vision_ids_dropped` counts the sampled vision special ids left out of
    them."""
    input_ids: np.ndarray                  # (L,)
    response_mask: np.ndarray              # (L,) 1 on the model's action tokens
    image_grid_thw: Optional[np.ndarray]   # (n_images, 3)
    image_embeds: Optional[Any]            # (rows, hidden) tensor on the device
    score: float                           # the env's return (sum of rewards)
    penalty: float                         # format penalty total
    group_id: int
    env_id: int
    tag: str
    frames: List[np.ndarray]
    llm_raw_texts: List[str]
    turns: int
    solved: bool
    vision_ids_dropped: int = 0


def _cat_rows(rows: List[Any]):
    return rows[0] if len(rows) == 1 else torch.cat(rows, dim=0)


class EnvManager:
    """One environment's multi-turn episode through a RequestScheduler.

    Each turn appends the observation (text and an optional image) to the
    token history -- the image's placeholder expanded to its grid's merged
    token count, its ViT rows computed once and kept -- and sends the whole
    prompt (every turn, every image) as one request; the scheduler's sticky
    worker and the engine see the prompt grow. The sampled action ids are
    appended verbatim, less any vision special id (counted in the
    episode's `vision_ids_dropped`)."""

    def __init__(self, *, env, processor, scheduler, embed_fn=None,
                 sampling=None, max_turns: int = 8, prompt_length: int = 4096,
                 group_id: int = 0, env_id: int = 0, tag: str = "env",
                 format_penalty: float = 0.0,
                 system: str = "You are a helpful assistant."):
        self.env = env
        self.processor = processor
        self.scheduler = scheduler
        self.embed_fn = embed_fn            # (list of u8 images, grids) -> rows
        self.sampling = sampling
        self.max_turns = max_turns
        self.prompt_length = prompt_length
        self.group_id, self.env_id, self.tag = group_id, env_id, tag
        self.format_penalty = format_penalty
        self.system = system
        self.vision_ids = vision_token_ids(processor)

    # the sequence is a concatenation of per-segment encodes (the byte-level
    # tokenizer and HF's Qwen tokenizer both round-trip at <|im_start|>)
    def _enc(self, text: str) -> List[int]:
        return list(self.processor.tokenizer.encode(text))

    def _user_block(self, text: str, n_images: int) -> List[int]:
        part = "<|vision_start|><|image_pad|><|vision_end|>" * n_images
        return self._enc(f"<|im_start|>user\n{part}{text}<|im_end|>\n")

    def run_episode(self, seed: int = 0, request_counter=None) -> Episode:
        proc = self.processor
        merge_unit = proc.merge_size ** 2
        ids: List[int] = self._enc(f"<|im_start|>system\n{self.system}<|im_end|>\n")
        resp_mask: List[int] = [0] * len(ids)
        grids: List[np.ndarray] = []
        images_u8: List[np.ndarray] = []
        embed_rows: List[Any] = []          # per-image ViT rows, embedded once
        frames: List[np.ndarray] = []
        raw_texts: List[str] = []
        score = penalty = 0.0
        solved = False
        dropped = 0
        obs = self.env.reset(seed=seed)
        turns = 0
        for turn in range(self.max_turns):
            text, image = _obs_parts(obs)
            n_img = 0
            if image is not None:
                u8 = np.asarray(image, np.uint8)
                icfg = proc.image_config
                gh, gw = u8.shape[0] // icfg.patch_size, u8.shape[1] // icfg.patch_size
                grids.append(np.array([1, gh, gw], np.int64))
                images_u8.append(u8)
                frames.append(u8)
                n_img = 1
            block = self._user_block(text, n_img)
            if n_img:
                # the one image_pad expanded to the image's merged token count
                t, h, w = grids[-1]
                n_tok = int(t * h * w) // merge_unit
                out_blk: List[int] = []
                for tok in block:
                    out_blk.extend([tok] * n_tok if tok == proc.image_token_id else [tok])
                block = out_blk
            hdr = self._enc("<|im_start|>assistant\n")
            if len(ids) + len(block) + len(hdr) > self.prompt_length:
                # the context budget: drop the unsent block and its image, so
                # that ids, grids and embeds stay consistent for training
                if n_img:
                    grids.pop(), images_u8.pop(), frames.pop()
                break
            ids += block + hdr
            resp_mask += [0] * (len(ids) - len(resp_mask))
            grid_arr = np.stack(grids) if grids else None
            row = np.asarray(ids, np.int64)[None]
            pos, _ = get_rope_index(proc_config_of(self), row, grid_arr, np.ones_like(row))
            embeds = None
            if images_u8 and self.embed_fn is not None:
                # each image's rows are embedded once, on the turn it arrives
                while len(embed_rows) < len(images_u8):
                    k = len(embed_rows)
                    embed_rows.append(self.embed_fn([images_u8[k]], grids[k][None]))
                embeds = _cat_rows(embed_rows)
            rid = (self.env_id, turn) if request_counter is None else \
                request_counter.get_value()
            req = BatchProto.from_dict(
                tensors={"input_ids": row, "attention_mask": np.ones_like(row),
                         "position_ids": pos},
                meta={"request_id": rid, "src_rank": self.env_id,
                      "sampling": self.sampling, "image_embeds": embeds})
            out = self.scheduler.generate_one_request(req)
            if out is None:                            # aborted
                break
            sampled = out.meta["output_token_ids"][0]
            act_ids = [t for t in sampled if t not in self.vision_ids]
            dropped += len(sampled) - len(act_ids)
            act_text = proc.decode(act_ids, skip_special_tokens=True)
            raw_texts.append(act_text)
            ids += act_ids
            resp_mask += [1] * len(act_ids)
            suffix = self._enc("<|im_end|>\n")
            ids += suffix
            resp_mask += [0] * len(suffix)
            turns += 1
            obs, reward, done, info = self.env.step(act_text)
            score += float(reward)
            if "format" in info:
                penalty += self.format_penalty
            if done:
                solved = bool(info.get("solved", False))
                break
        embeds = None
        if embed_rows:
            embeds = _cat_rows(embed_rows)
        elif images_u8 and self.embed_fn is not None:
            embeds = self.embed_fn(images_u8, np.stack(grids) if grids else None)
        return Episode(
            input_ids=np.asarray(ids, np.int64),
            response_mask=np.asarray(resp_mask, np.int64),
            image_grid_thw=np.stack(grids) if grids else None,
            image_embeds=embeds, score=score, penalty=penalty,
            group_id=self.group_id, env_id=self.env_id, tag=self.tag,
            frames=frames, llm_raw_texts=raw_texts, turns=turns, solved=solved,
            vision_ids_dropped=dropped)


VISION_SPECIAL_TOKENS = ("<|vision_end|>", "<|vision_pad|>")


def vision_token_ids(processor) -> frozenset:
    """The vision special ids no action may hold: the image, video and
    vision-start ids of the processor's model config, and <|vision_end|>
    and <|vision_pad|> where its tokenizer defines them (a byte tokenizer's
    `special` table, or an HF tokenizer's added vocabulary). A processor
    without a model config is refused, as `proc_config_of` refuses it."""
    cfg = _model_config(processor)
    ids = {cfg.image_token_id, cfg.video_token_id, cfg.vision_start_token_id}
    tok = processor.tokenizer
    table = getattr(tok, "special", None)
    if table is None and hasattr(tok, "get_added_vocab"):
        table = tok.get_added_vocab()
    ids.update(int(table[name]) for name in VISION_SPECIAL_TOKENS if name in (table or {}))
    return frozenset(ids)


def proc_config_of(mgr: "EnvManager"):
    """The model config get_rope_index needs (the image and vision token ids,
    the merge geometry); an EnvManager reads it from its processor, so it
    stays model-agnostic."""
    return _model_config(mgr.processor)


def _model_config(processor):
    cfg = getattr(processor, "model_config", None)
    if cfg is None:
        raise ValueError("EnvManager's processor needs .model_config set "
                         "(Qwen25VLConfig) for M-RoPE position ids")
    return cfg
