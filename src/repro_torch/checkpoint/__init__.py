from repro_torch.checkpoint.sharded import (
    CheckpointManager, save_checkpoint, load_checkpoint, latest_step,
    encode_json, decode_json,
)
