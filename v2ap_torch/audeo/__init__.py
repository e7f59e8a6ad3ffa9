"""Audeo piano subsystem of the port: Video2Roll perception
(``models/video2roll``), the Roll2Midi cleanup GAN, datasets, training
loops, evaluation metrics, and dependency-free MIDI synthesis. Counterpart
of ``v2ap_tpu/audeo/``, exporting the same names."""

from v2ap_torch.audeo.roll2midi import (  # noqa: F401
    AttentionGate, Roll2MidiDiscriminator, Roll2MidiGenerator,
)
from v2ap_torch.audeo.synth import (  # noqa: F401
    MidiSynth, roll_to_notes, synthesize_notes, write_midi_file,
)
from v2ap_torch.audeo.evaluate import RollMetrics, evaluate_rolls, evaluate_per_key  # noqa: F401
from v2ap_torch.audeo.datasets import (  # noqa: F401
    Roll2MidiPairs, Video2RollSamples, load_roll_chunk_dir,
    video2roll_infer_chunks,
)
from v2ap_torch.audeo.train import (  # noqa: F401
    Roll2MidiTrainer, Video2RollTrainer,
)
