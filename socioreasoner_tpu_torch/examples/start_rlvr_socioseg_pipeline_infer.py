"""SocioSeg evaluation entry of the port: yaml → SocioSegConfig →
build_infer_pipeline → run(), the two-stage reason→segment loop over the
test split, writing iou_acc.txt.

The counterpart of examples/start_rlvr_socioseg_pipeline_infer.py, reading
the same yaml files (`examples/infer/rlvr_tpu.yaml` by default, with
`pretrain` and seg_infer's `model_name_or_path` set to local HF checkpoint
directories; --device cpu runs it on the CPU):

    python -m socioreasoner_tpu_torch.examples.start_rlvr_socioseg_pipeline_infer \
        --config_path examples/infer --config_name rlvr_tpu.yaml
"""

import argparse

from socioreasoner_tpu_torch.configs.loader import load_config
from socioreasoner_tpu_torch.configs.rlvr_config import SocioSegConfig
from socioreasoner_tpu_torch.pipeline.rlvr import build


def main(argv=None):
    """Build the pipeline from the yaml, run it, and return it."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_path", default="examples/infer")
    parser.add_argument("--config_name", default="rlvr_tpu.yaml")
    parser.add_argument("--device", default=None,
                        help="where the models run (default: the GPU)")
    args = parser.parse_args(argv)
    cfg = load_config(SocioSegConfig, f"{args.config_path}/{args.config_name}")
    pipeline = build.build_infer_pipeline(cfg, device=args.device)
    pipeline.run()
    return pipeline


if __name__ == "__main__":
    main()
