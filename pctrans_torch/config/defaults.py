"""Default configuration tree: a copy of ``pctrans_tpu/config/defaults.py``,
so that the two packages merge the same YAMLs into the same tree (held
equal by ``tests/test_torch_config.py``).  Key names follow the reference
framework; unknown keys from user YAMLs are accepted and carried through.
Keys the port does not act on yet (the TPU recipe's remat knobs, the
volumetric and augmentor blocks, the JAX profiler window) are carried so the
trees stay equal.
"""

from .node import CfgNode


def get_cfg_defaults() -> CfgNode:
    c = CfgNode()

    # ------------------------------------------------------------------ SYSTEM
    c.SYSTEM = CfgNode()
    c.SYSTEM.NUM_GPUS = 1            # kept for config compatibility; on TPU this
    c.SYSTEM.NUM_CPUS = 4            # maps to the number of mesh devices.
    c.SYSTEM.NUM_DEVICES = -1        # -1: use all local JAX devices
    c.SYSTEM.PARALLEL = "DP"
    c.SYSTEM.DISTRIBUTED = False
    c.SYSTEM.DISTRIBUTED_BACKEND = "ici"  # reference: nccl / gloo

    # ------------------------------------------------------------------- MODEL
    c.MODEL = CfgNode()
    c.MODEL.ARCHITECTURE = "MaskFormer"
    c.MODEL.INPUT_SIZE = [448, 448]
    c.MODEL.OUTPUT_SIZE = [1, 448, 448]
    c.MODEL.IN_PLANES = 3
    c.MODEL.OUT_PLANES = 1
    c.MODEL.TARGET_OPT = ["9"]
    c.MODEL.WEIGHT_OPT = [["1"]]
    # legacy multi-target criterion (reference defaults.py LOSS_* keys)
    c.MODEL.LOSS_OPTION = [["WeightedBCE"]]
    c.MODEL.LOSS_WEIGHT = [[1.0]]
    c.MODEL.OUTPUT_ACT = [["none"]]
    c.MODEL.LOSS_KWARGS_KEY = None
    c.MODEL.LOSS_KWARGS_VAL = None
    c.MODEL.REGU_OPT = None
    c.MODEL.REGU_TARGET = None
    c.MODEL.REGU_WEIGHT = None
    c.MODEL.LABEL_EROSION = 0
    c.MODEL.LABEL_DILATION = 0
    c.MODEL.BLOCK_TYPE = "residual"
    c.MODEL.NORM_MODE = "sync_bn"    # on TPU batch stats sync via the data axis
    # legacy-zoo knobs (reference defaults.py; consumed by build_architecture)
    c.MODEL.FILTERS = [28, 36, 48, 64, 80]
    c.MODEL.BLOCKS = [2, 2, 2, 2]
    c.MODEL.KERNEL_SIZES = [3, 3, 5, 3, 3]
    c.MODEL.ISOTROPY = [False, False, False, True, True]
    c.MODEL.PAD_MODE = "replicate"
    c.MODEL.ACT_MODE = "elu"
    c.MODEL.POOLING_LAYER = False
    c.MODEL.ATTENTION = "squeeze_excitation"
    c.MODEL.BACKBONES = "resnet"     # fpn_3d backbone (reference MODEL.BACKBONES)
    c.MODEL.DEPLOY_MODE = False      # RepVGG deploy mode
    c.MODEL.AUX_OUT = False          # DeepLab auxiliary classifier
    c.MODEL.EMBEDDING = 1            # unet_residual_3d embedding path
    c.MODEL.HEAD_DEPTH = 1
    c.MODEL.RETURN_FEATS = None
    c.MODEL.MIXED_PRECESION = False  # (sic) key name kept for compatibility
    c.MODEL.PRE_MODEL_ITER = 0
    c.MODEL.WEIGHTS = ""             # path to converted R-50 weights (.pkl or .npz)
    c.MODEL.PIXEL_MEAN = [0.0, 0.0, 0.0]
    c.MODEL.PIXEL_STD = [255.0, 255.0, 255.0]
    # Maximum number of padded GT instances per image (static shapes for jit).
    # CVPPP leaves max ~45/image; BBBC nuclei can exceed 100.
    c.MODEL.MAX_INSTANCES = 64

    c.MODEL.BACKBONE = CfgNode()
    c.MODEL.BACKBONE.NAME = "build_resnet_backbone"
    c.MODEL.BACKBONE.FREEZE_AT = 0

    c.MODEL.RESNETS = CfgNode()
    c.MODEL.RESNETS.DEPTH = 50
    c.MODEL.RESNETS.STEM_OUT_CHANNELS = 64
    c.MODEL.RESNETS.STEM_TYPE = "basic"
    c.MODEL.RESNETS.RES2_OUT_CHANNELS = 256
    c.MODEL.RESNETS.STRIDE_IN_1X1 = False
    c.MODEL.RESNETS.OUT_FEATURES = ["res2", "res3", "res4", "res5"]
    c.MODEL.RESNETS.NORM = "FrozenBN"
    c.MODEL.RESNETS.RES5_MULTI_GRID = [1, 1, 1]

    c.MODEL.SEM_SEG_HEAD = CfgNode()
    c.MODEL.SEM_SEG_HEAD.NAME = "MaskFormerHead"
    c.MODEL.SEM_SEG_HEAD.IGNORE_VALUE = 0
    c.MODEL.SEM_SEG_HEAD.NUM_CLASSES = 2
    c.MODEL.SEM_SEG_HEAD.LOSS_WEIGHT = 1.0
    c.MODEL.SEM_SEG_HEAD.CONVS_DIM = 128
    c.MODEL.SEM_SEG_HEAD.MASK_DIM = 16
    c.MODEL.SEM_SEG_HEAD.NORM = "SyncBN"
    c.MODEL.SEM_SEG_HEAD.PIXEL_DECODER_NAME = "MSDeformAttnPixelDecoder"
    # replicate the published FPN operand swap (stride-8 mask features
    # instead of the upstream Mask2Former stride-4 fusion; see
    # models/pixel_decoder.py fpn_legacy_swap docstring)
    c.MODEL.SEM_SEG_HEAD.FPN_LEGACY_SWAP = False
    c.MODEL.SEM_SEG_HEAD.IN_FEATURES = ["res2", "res3", "res4", "res5"]
    c.MODEL.SEM_SEG_HEAD.DEFORMABLE_TRANSFORMER_ENCODER_IN_FEATURES = ["res3", "res4", "res5"]
    c.MODEL.SEM_SEG_HEAD.COMMON_STRIDE = 4
    c.MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS = 6

    mf = CfgNode()
    mf.TRANSFORMER_DECODER_NAME = "MultiScaleMaskedTransformerDecoder"
    mf.TRANSFORMER_IN_FEATURE = "multi_scale_pixel_decoder"
    mf.DEEP_SUPERVISION = True
    mf.NO_OBJECT_WEIGHT = 0.1
    mf.CLASS_WEIGHT = 2.0
    mf.MASK_WEIGHT = 5.0
    mf.DICE_WEIGHT = 5.0
    mf.REID_WEIGHT_QUERY = 2.0
    mf.REID_WEIGHT_MASK = 2.0
    mf.REF_POINTS_WEIGHT = 5.0
    mf.SEM_WEIGHT = 5.0
    mf.EMB_WEIGHT = 2.0
    mf.SEMANTIC_LOSS_ON = True
    mf.SEMANTIC_NORM = "SyncBN"
    mf.POSITION_POINTS_NUM = 1
    mf.REL_COORD = True
    mf.HIDDEN_DIM = 128
    mf.NUM_OBJECT_QUERIES = 100
    mf.NHEADS = 8
    mf.DROPOUT = 0.0
    mf.DIM_FEEDFORWARD = 1024
    mf.ENC_LAYERS = 0
    mf.DEC_LAYERS = 10               # 9 decoder layers + 1 loss on learnable queries
    mf.PRE_NORM = False
    mf.ENFORCE_INPUT_PROJ = False
    mf.SIZE_DIVISIBILITY = 32
    mf.TRAIN_NUM_POINTS = 12544
    mf.OVERSAMPLE_RATIO = 3.0
    mf.IMPORTANCE_SAMPLE_RATIO = 0.75
    # TPU-recipe estimator knobs (losses/criterion.CriterionConfig): the
    # defaults deviate from the reference's data flow in provably
    # expectation-equivalent ways for speed; set POINT_SELECT "exact",
    # CANDIDATE_RATIO 3.0, EXACT_TARGETS True, SAMPLE_DTYPE "float32" and
    # UPSAMPLE2X True to reproduce the reference estimators bit-for-bit
    # (tools_dev/twin_recipe_run.py measures the metric-level delta).
    mf.TPU_RECIPE = CfgNode()
    # "dense" evaluates losses/matcher costs at every stride-4 logit pixel
    # (h*w ~ TRAIN_NUM_POINTS at these recipes) — the zero-variance member
    # of the same importance-weighted estimator family, with no sampling
    # contractions; "shared"/"weighted"/"topk" are the sampled variants.
    mf.TPU_RECIPE.POINT_SELECT = "dense"
    mf.TPU_RECIPE.CANDIDATE_RATIO = 1.0
    mf.TPU_RECIPE.EXACT_TARGETS = False
    mf.TPU_RECIPE.SAMPLE_DTYPE = "bfloat16"
    mf.TPU_RECIPE.UPSAMPLE2X = False
    # Rematerialize encoder/decoder layers + the dynamic-mask render in the
    # backward pass (HBM for FLOPs).  True fits any shape in 16G v5e HBM;
    # False saves the recompute when the batch fits (see ModelConfig.remat).
    mf.TPU_RECIPE.REMAT = True
    # "full" recomputes everything; "dots" saves matmul/conv outputs and
    # recomputes only elementwise chains (models/layers.remat_policy)
    mf.TPU_RECIPE.REMAT_POLICY = "full"
    mf.TEST = CfgNode()
    mf.TEST.SEMANTIC_ON = False
    mf.TEST.INSTANCE_ON = True
    mf.TEST.PANOPTIC_ON = False
    mf.TEST.OVERLAP_THRESHOLD = 0.8
    mf.TEST.OBJECT_MASK_THRESHOLD = 0.8
    mf.TEST.SEM_SEG_POSTPROCESSING_BEFORE_INFERENCE = False
    c.MODEL.MASK_FORMER = mf

    # ----------------------------------------------------------------- DATASET
    c.DATASET = CfgNode()
    c.DATASET.DATA_TYPE = "CVPPP"    # CVPPP | BBBC | synthetic
    c.DATASET.INPUT_PATH = ""
    c.DATASET.OUTPUT_PATH = "outputs/"
    c.DATASET.IMAGE_NAME = ""
    c.DATASET.LABEL_NAME = ""
    c.DATASET.VAL_IMAGE_NAME = None
    c.DATASET.VAL_LABEL_NAME = None
    # instance ids can exceed 32767: transfer labels as int32 instead of
    # int16 (static per run — see engine/trainer.py label_dtype note)
    c.DATASET.WIDE_LABELS = False
    # uint8 host->device batch transfer: images are affinely quantized to
    # uint8 over TRANSFER_UINT8_RANGE on the host and dequantized on device
    # (labels ship uint8 too when ids stay < 256, else the WIDE_LABELS rule
    # applies).  Halves the f16/int16 per-step bytes again — measured
    # 378 -> 135 ms/step through this environment's ~10 MB/s relay
    # (tools_dev/opt_train_loop.py); the <=(hi-lo)/510 quantization error
    # sits below bf16 compute rounding for unit-range sources.  OFF by
    # default: f32/f16 transfers remain the bit-parity path.
    c.DATASET.TRANSFER_UINT8 = False
    c.DATASET.TRANSFER_UINT8_RANGE = [0.0, 1.0]
    c.DATASET.DO_2D = True
    c.DATASET.IS_ISOTROPIC = False   # legacy-zoo kernel/stride isotropy
    c.DATASET.REDUCE_LABEL = True
    c.DATASET.PAD_SIZE = [0, 0, 0]
    c.DATASET.VAL_PAD_SIZE = [0, 0, 0]
    c.DATASET.DO_CHUNK_TITLE = 0
    c.DATASET.POST_PROCESS = "none"
    # volumetric (EM) path: VolumeDataset / TileDataset
    # (reference defaults.py:180-204)
    c.DATASET.VALID_MASK_NAME = None
    c.DATASET.MEAN = 0.5
    c.DATASET.STD = 0.5
    c.DATASET.DATA_CHUNK_NUM = [1, 1, 1]
    c.DATASET.DATA_CHUNK_IND = None
    c.DATASET.CHUNK_IND_SPLIT = None
    c.DATASET.DATA_CHUNK_STRIDE = True
    c.DATASET.DATA_CHUNK_ITER = 1000
    c.DATASET.REJECT_SAMPLING = CfgNode(
        {"SIZE_THRES": -1, "DIVERSITY": -1, "P": 0.95})

    # --------------------------------------------------------------- AUGMENTOR
    # Volume (EM-stack) augmentation blocks (reference defaults.py AUGMENTOR
    # section), consumed by data/volume_augment.build_train_augmentor.
    c.AUGMENTOR = CfgNode()
    c.AUGMENTOR.SMOOTH = False
    c.AUGMENTOR.ADDITIONAL_TARGETS_NAME = ["label"]
    c.AUGMENTOR.ADDITIONAL_TARGETS_TYPE = ["mask"]
    c.AUGMENTOR.ROTATE = CfgNode({"ENABLED": True, "P": 0.5, "ROT90": True})
    c.AUGMENTOR.RESCALE = CfgNode({"ENABLED": True, "P": 0.5})
    c.AUGMENTOR.FLIP = CfgNode({"ENABLED": True, "P": 1.0, "DO_ZTRANS": 0})
    c.AUGMENTOR.ELASTIC = CfgNode(
        {"ENABLED": True, "P": 0.75, "ALPHA": 16.0, "SIGMA": 4.0})
    c.AUGMENTOR.GRAYSCALE = CfgNode({"ENABLED": True, "P": 0.75})
    c.AUGMENTOR.MISALIGNMENT = CfgNode(
        {"ENABLED": True, "P": 0.5, "DISPLACEMENT": 16, "ROTATE_RATIO": 0.0})
    c.AUGMENTOR.MISSINGSECTION = CfgNode(
        {"ENABLED": True, "P": 0.5, "NUM_SECTION": 2})
    c.AUGMENTOR.MISSINGPARTS = CfgNode({"ENABLED": True, "P": 0.9, "ITER": 64})
    c.AUGMENTOR.MOTIONBLUR = CfgNode(
        {"ENABLED": False, "P": 0.5, "SECTIONS": 2, "KERNEL_SIZE": 11})
    c.AUGMENTOR.CUTBLUR = CfgNode(
        {"ENABLED": False, "P": 0.5, "LENGTH_RATIO": 0.25,
         "DOWN_RATIO_MIN": 2.0, "DOWN_RATIO_MAX": 8.0, "DOWNSAMPLE_Z": False})
    c.AUGMENTOR.CUTNOISE = CfgNode(
        {"ENABLED": False, "P": 0.75, "LENGTH_RATIO": 0.25, "SCALE": 0.2})
    c.AUGMENTOR.COPYPASTE = CfgNode({"ENABLED": False, "P": 0.8})

    # ------------------------------------------------------------------ SOLVER
    c.SOLVER = CfgNode()
    c.SOLVER.NAME = "AdamW"
    c.SOLVER.BASE_LR = 1e-4
    c.SOLVER.BIAS_LR_FACTOR = 1.0
    c.SOLVER.MOMENTUM = 0.9
    c.SOLVER.BETAS = (0.9, 0.999)
    c.SOLVER.WEIGHT_DECAY = 0.05
    c.SOLVER.WEIGHT_DECAY_NORM = 0.0
    c.SOLVER.WEIGHT_DECAY_BIAS = 0.0
    c.SOLVER.BACKBONE_MULTIPLIER = 0.1   # present in configs; reference disables it
    c.SOLVER.LR_SCHEDULER_NAME = "WarmupPolyLR"
    c.SOLVER.WARMUP_FACTOR = 0.001
    c.SOLVER.WARMUP_ITERS = 1000
    c.SOLVER.WARMUP_METHOD = "linear"
    c.SOLVER.POLY_POWER = 0.9
    c.SOLVER.GAMMA = 0.1
    c.SOLVER.STEPS = (30000,)
    c.SOLVER.ITERATION_TOTAL = 30000
    c.SOLVER.ITERATION_STEP = 1
    c.SOLVER.ITERATION_SAVE = 1000
    c.SOLVER.ITERATION_VAL = 1000
    c.SOLVER.START_SAVE = 10000
    c.SOLVER.ITERATION_RESTART = False
    c.SOLVER.SAMPLES_PER_BATCH = 2
    c.SOLVER.CLIP_GRADIENTS = CfgNode()
    c.SOLVER.CLIP_GRADIENTS.ENABLED = False
    c.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "full_model"
    c.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 0.01
    c.SOLVER.CLIP_GRADIENTS.NORM_TYPE = 2.0
    c.SOLVER.SWA = CfgNode()
    c.SOLVER.SWA.ENABLED = False
    c.SOLVER.SWA.LR_FACTOR = 0.05
    c.SOLVER.SWA.START_ITER = 0
    c.SOLVER.SWA.MERGE_ITER = 10
    c.SOLVER.SWA.BN_UPDATE_ITER = 10

    # ----------------------------------------------------------------- MONITOR
    c.MONITOR = CfgNode()
    c.MONITOR.LOG_OPT = [1, 1, 0]
    c.MONITOR.VIS_OPT = [0, 8]
    c.MONITOR.ITERATION_NUM = [20, 200]
    c.MONITOR.PROFILE_ITERS = None   # (start, stop) iteration window for a torch.profiler trace
    # TensorBoard event stream (torch.utils.tensorboard). The first writer
    # import drags in tens of seconds of torch/tensorflow machinery on a
    # small host, so CI-style runs can turn it off; the JSONL stream is the
    # always-on machine-readable record.
    c.MONITOR.TENSORBOARD = True

    # --------------------------------------------------------------- INFERENCE
    c.INFERENCE = CfgNode()
    # None = inherit MODEL.INPUT_SIZE/OUTPUT_SIZE (reference defaults.py:412);
    # set to evaluate at a different window than training
    c.INFERENCE.INPUT_SIZE = None
    c.INFERENCE.OUTPUT_SIZE = None
    c.INFERENCE.INPUT_PATH = ""
    c.INFERENCE.OUTPUT_PATH = "outputs/test/"
    c.INFERENCE.IMAGE_NAME = ""
    c.INFERENCE.OUTPUT_NAME = "result.h5"
    c.INFERENCE.OUTPUT_ACT = ["sigmoid"]
    c.INFERENCE.PAD_SIZE = None  # None = inherit DATASET.PAD_SIZE
    c.INFERENCE.AUG_MODE = None
    c.INFERENCE.AUG_NUM = None
    c.INFERENCE.STRIDE = [0, 80, 80]
    c.INFERENCE.SAMPLES_PER_BATCH = 4
    # config-compat knob (reference gates label loading at inference with
    # it); this rebuild's EM evaluation is offline (scripts/eval_em.py on
    # saved volumes), so it is accepted but has no effect
    c.INFERENCE.DO_EVAL = True
    # New key (TPU rebuild): upsample only the TOP_K highest-peak query masks
    # to full resolution in the jitted eval step; <= 0 upsamples all queries.
    # Exact whenever <= TOP_K queries clear the postprocess threshold (the
    # trainer checks and warns otherwise).
    c.INFERENCE.TOP_K = 50

    # -------------------------------------------------------------------- TEST
    c.TEST = CfgNode()
    c.TEST.DETECTIONS_PER_IMAGE = 100
    c.TEST.THRESHOLD = 0.5

    return c
