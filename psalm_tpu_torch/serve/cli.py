"""Local interactive chat CLI: an image and a conversation read from stdin,
no server (reference: psalm/serve/cli.py).

Counterpart of ``psalm_tpu/serve/cli.py`` on the port's
``load_pretrained_model`` and ``Generator``, with the same flags and
``--device`` (the card by default):

    python -m psalm_tpu_torch.serve.cli --model-path DIR [--image-file IMG]

An empty line or the end of stdin ends the conversation.
"""

from __future__ import annotations

import argparse

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model-path", required=True)
    p.add_argument("--image-file", default=None)
    p.add_argument("--temperature", type=float, default=0.2)
    p.add_argument("--max-new-tokens", type=int, default=512)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def chat(args, tokenizer, model, context_len: int) -> None:
    """The conversation loop on a loaded model."""
    from psalm_tpu_torch.data.conversation import conv_llava_phi
    from psalm_tpu_torch.data.mappers import ImageMapper
    from psalm_tpu_torch.data.splicer import splice, stack_samples
    from psalm_tpu_torch.data.tokenization import tokenize_special
    from psalm_tpu_torch.models.generation import Generator

    gen = Generator(model, max_len=context_len, device=args.device)
    mapper = ImageMapper(model.cfg.image_size)
    num_image_tokens = (mapper.image_size // 64) ** 2

    image_arr = np.zeros((1, mapper.image_size, mapper.image_size, 3),
                         np.float32)
    if args.image_file:
        from PIL import Image
        proc = mapper.transform_image(
            np.asarray(Image.open(args.image_file).convert("RGB")))
        image_arr = proc.image[None]

    conv = conv_llava_phi.copy()
    first = True
    while True:
        try:
            inp = input("USER: ")
        except EOFError:
            break
        if not inp:
            break
        if first and args.image_file:
            inp = "<image>\n" + inp
            first = False
        conv.append_message(conv.roles[0], inp)
        conv.append_message(conv.roles[1], "")
        prompt = conv.get_prompt()
        input_ids = tokenize_special(prompt, tokenizer)
        s = splice(input_ids, None, num_image_tokens=num_image_tokens,
                   num_seg_queries=1,
                   pad_len=len(input_ids) + num_image_tokens + 8)
        batch = stack_samples([s])
        batch["images"] = image_arr
        toks = gen.generate(batch, max_new_tokens=args.max_new_tokens,
                            temperature=args.temperature,
                            eos_id=getattr(tokenizer, "eos_token_id", None))
        out = tokenizer.decode(toks[0].tolist(), skip_special_tokens=True)
        print("ASSISTANT:", out)
        conv.messages[-1][1] = out


def main(argv=None):
    args = parse_args(argv)
    from psalm_tpu_torch.models.builder import load_pretrained_model
    tokenizer, model, context_len = load_pretrained_model(
        args.model_path, device=args.device)
    if tokenizer is None:
        raise SystemExit(f"{args.model_path} holds no tokenizer that "
                         "transformers can load")
    chat(args, tokenizer, model, context_len)


if __name__ == "__main__":
    main()
