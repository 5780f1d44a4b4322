"""The legacy model families (pvpuformer_tpu/models/zoo): SegFormer (MiT),
HRNet+OCR, DeepLabV3+ (ResNet), Swin, HRFormer and Swin-UNet, each an
interactive-segmentation model with the RITM coord-feature inputs. Their
convolutions, frozen batch norm and window attention are plain PyTorch, as
JAX computes them with XLA; no Pallas kernel is on their path. `clip_text`
holds the CLIP text encoder and visual towers of caption co-training."""
